"""The share of the card's peak that the useful work took: dense-equivalent
FLOPs (benchmark/roofline.py) of the tokens served or scored over the
counted seconds times 989 TFLOP/s. Serving: every decode token served at
its own context, and every prompt whose prefill gave its first token in
the span; perplexity: every window scored. The span is the window, or in
a traced run its part before the first capture."""
from benchmark import readers as R


def read(run):
    return R.share_of_peak(run, "useful_flops")
