"""Raft and FSM: mean ``raft.wait`` span (an apply's wait for the raft
lock, every entry whatever its type), ms."""
import readout


def read(ctx):
    return readout.mean_ms(ctx, "raft.wait")
