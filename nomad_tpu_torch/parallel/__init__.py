"""Device seams (which device the port computes on, and the counted
host<->device transfers), device meshes with the node-axis-sharded
forms of the placement kernels (K7), and the window-verify kernel
(K6)."""
