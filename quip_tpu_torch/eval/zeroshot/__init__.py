"""The zero-shot harness (port of ``quip_tpu/eval/zeroshot``).

``metrics``, ``base``, ``tasks``, ``registry``, ``synthetic_docs`` and
``evaluator`` are numpy and plain Python, copied from quip_tpu so the port
imports nothing of it; ``lm.TorchLM`` scores through the port's model.
"""
from quip_tpu_torch.eval.zeroshot.registry import TASK_REGISTRY, get_task_dict  # noqa: F401
from quip_tpu_torch.eval.zeroshot.evaluator import evaluate, simple_evaluate, make_table  # noqa: F401
