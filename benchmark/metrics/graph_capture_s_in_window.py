"""Seconds the engine spent building chunk graphs inside the window (the
difference of ChunkGraphs.capture_s): 0 when set-up built every graph the
traffic reaches."""
from benchmark import readers as R


def read(run):
    return R.fact(run, "graph_capture_s_in_window")
