"""Evaluation (port of ``quip_tpu/eval``): windowed perplexity (``ppl.py``)
and the zero-shot harness (``zeroshot/``)."""
