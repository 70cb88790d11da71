"""Broker: mean ``broker.wait`` span (an eval's wait in a ready queue), ms."""
import readout


def read(ctx):
    return readout.mean_ms(ctx, "broker.wait")
