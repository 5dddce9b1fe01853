"""The port's vlm and audio LMs against the JAX package.

Whole model, at reduced_config (B = 2, S = 32): the prefill's last logits
and cache, then one decode step's logits and cache from the reference's
padded cache, converted.  vlm: gated cross-attention to 16 projected vision
tokens (padded to a 128 tile and masked) every 5th layer; audio: a
2-layer bidirectional encoder over projected frames, and 2 decoder layers
with self- and cross-attention.  The cross-attention gates are moved off
their init of 0 (``_torch_models.perturb``), or the path would add nothing.
Bounds as a share of max |reference|: float32 1e-4 (measured on the CPU
≤ 1.3e-6), bfloat16 2e-2 (measured ≤ 1.5e-2, vlm's last logits).
"""

import functools

import pytest

from _torch_models import TOL, configs, prefill_decode_case, rel_err, tree_errs

ARCHS = ["llama-3.2-vision-90b", "seamless-m4t-medium"]
PARTS = ["last", "cache", "dec", "dcache"]


@functools.lru_cache(maxsize=None)
def _case(arch, dtype):
    rcfg, pcfg = configs(arch, dtype)
    return prefill_decode_case(rcfg, pcfg)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_multimodal_prefill_and_decode_match(arch, dtype, part):
    case = _case(arch, dtype)
    ref, got = case[f"ref_{part}"], case[f"port_{part}"]
    if part in ("cache", "dcache"):
        errs = tree_errs(ref, got)
        assert max(errs.values()) <= TOL[dtype], errs
    else:
        assert rel_err(ref, got) <= TOL[dtype]
