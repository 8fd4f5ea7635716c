"""The decode step's share of the card's peak, as the card runs it: the
decode steps run in the counted span (K1-decode launches, the program's
counter, over the 4 packed linears a layer), each over all of the
engine's batch rows, idle slots included, at the mean context of the
tokens served, in dense-equivalent FLOPs (benchmark/roofline.py::
step_flops), over the span's seconds times 989 TFLOP/s. Below the knee
the useful FLOPs a second are set by the offered load; this share moves
with the step's time."""
from benchmark import readers as R


def read(run):
    return R.share_of_peak(run, "step_flops")
