"""Shared helpers of the port's training tests (tests/test_torch_train*.py,
tests/test_torch_launch_train.py).

``grads_case`` runs one reduced config's loss and gradients on both
packages from the same weights and batch (``_torch_models.reference_pair``
with ``data_size=1``, so that a MoE's experts map one to one) and returns
both losses and each gradient's error as a share of its tensor's max
|gradient|.  ``smoke_batch`` is the reference's ``tests/test_models.py``
``_batch`` drawn with numpy: (B, S + 1) tokens in [1, vocab), the vlm's
vision embeddings and the audio model's frames in bfloat16.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_models import configs, make_batch, reference_pair, to_port, to_ref, tree_errs
from repro_torch.models import convert
from repro_torch.train import loss_and_grads

LOSS_RTOL = 1e-5  # loss, nll and aux, relative
GRAD_TOL = 1e-4  # each gradient, as a share of its tensor's max |gradient|


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The training tests run many small CPU operators, which gain nothing
    from intra-op threads; with one each, parallel test workers do not
    oversubscribe the cores.  Imported by a test module, it holds for that
    module and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loss_tol_ok(ref, got) -> bool:
    ref, got = float(ref), float(got)
    return abs(ref - got) <= LOSS_RTOL * abs(ref) if ref else got == 0.0


def grads_case(arch, dtype="float32", B=2, S=32, seed=0, **replace):
    rcfg, pcfg = configs(arch, dtype, **replace)
    rm, jp, _, pm = reference_pair(rcfg, pcfg, seed, data_size=1)
    batch = make_batch(rcfg, B, S + 1, seed + 1)
    (r_loss, r_met), r_grads = jax.jit(jax.value_and_grad(rm.loss_fn, has_aux=True))(
        jp, to_ref(batch))
    p_loss, p_met, p_grads = loss_and_grads(pm, to_port(batch))
    return {
        "ref": {"loss": r_loss, "nll": r_met["nll"], "aux": r_met["aux"]},
        "port": {"loss": p_loss, "nll": p_met["nll"], "aux": p_met["aux"]},
        "grad_errs": tree_errs(jax.tree.map(np.asarray, r_grads),
                               convert.params_to_reference(pcfg, p_grads, data_size=1)),
    }


def smoke_batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_vision))
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, S, cfg.d_audio))
    return {k: torch.from_numpy(v) if k == "tokens"
            else torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16) for k, v in b.items()}

