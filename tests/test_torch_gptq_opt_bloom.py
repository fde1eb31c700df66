"""Port parity: whole-model GPTQ on the tiny OPT and BLOOM models (the
cases of ``tests/test_torch_gptq_model.py`` that are not LLaMA's, in a file
of their own so that each file stays short): OPT with act-order, packed
(true-sequential) and fake-quant; BLOOM with the TrueOBS solver, packed
and with ``sparseout`` (fake-quant, true-sequential).  The same criteria:
layer 0's codes at least 99% equal to the JAX package's, synthetic
perplexity within rel 2e-3 of JAX's, output error below RTN's.
"""

import pytest

from test_torch_gptq_model import (  # noqa: F401  (fixtures)
    GPTQ_CASES,
    _two_threads,
    calib,
    check_gptq_case,
    models,
)


@pytest.mark.parametrize("case", [c for c in GPTQ_CASES if not c.startswith("llama")])
def test_quantize_model_gptq_matches_jax(models, calib, case):  # noqa: F811
    check_gptq_case(models, calib, case)
