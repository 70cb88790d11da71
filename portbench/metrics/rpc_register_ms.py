"""RPC edge: mean ``rpc.serve.Job.Register`` span, ms."""
import readout


def read(ctx):
    return readout.mean_ms(ctx, "rpc.serve.Job.Register")
