"""Device: bytes uploaded host to device (``bytes`` of every device seam
span of ``kind`` h2d) over the window's completed evals, MB an eval."""
import readout
import spanread


def read(ctx):
    if not readout.usable(ctx):
        return None
    ups = [s for s in spanread.device(ctx)
           if (s.get("tags") or {}).get("kind") == "h2d"]
    if not ups:
        return None
    return readout.per_eval(ctx, sum(s["tags"]["bytes"] for s in ups) / 1e6)
