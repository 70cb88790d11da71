"""Device seams (which device the port computes on, and the counted
host<->device transfers) and the window-verify kernel (K6)."""
