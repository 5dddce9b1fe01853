"""The sharded MoE's backward and the train step on a mesh, against the JAX
package's gradients on the CPU (tests/_moe_train_runs.py: 8 gloo ranks and 8
host devices, each side in a subprocess with its own timeout, both started
together).

* each collective alone (all_to_all over data, psum_scatter, all_gather
  and psum over model, as the reference calls them): every rank's output
  and input gradient equal to ``jax.vjp``'s under ``shard_map``;
* ``moe_apply_sharded`` under the specs of the reference's ``_moe_ffn``
  (capacity 1.0 with a shared expert on (4, 2); 4 experts held twice on
  (8, 1)): each rank's gradient, brought to the global one as the train
  step does, within 1e-4 of each tensor's max of ``jax.vjp``'s;
* ``LMModel.loss_fn`` with the sharded MoE (reduced deepseek-v2-lite on
  (4, 2), reduced grok-1 on (8, 1), capacity 1.25): every parameter's
  gradient on every rank within 1e-4 of its tensor's max of
  ``jax.value_and_grad``'s (the reference's replica slots summed), nll
  within 1e-5 relative, loss and aux the reference's values; after one
  adamw step every rank holds the same parameters.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _moe_sharded_runs import CASES
from _moe_train_runs import COLLECTIVES, MODEL_CASES, MOE_CASES, WORLD

ROOT = Path(__file__).resolve().parents[1]
RUNS = Path(__file__).resolve().parent / "_moe_train_runs.py"
GRAD_TOL = 1e-4  # each gradient, as a share of its tensor's max |gradient|
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' multi-process runs, started together; -> their
    output directory."""
    out = tmp_path_factory.mktemp("moe_train")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = {side: subprocess.Popen([sys.executable, str(RUNS), side, str(out)], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for side in ("torch", "jax")}
    try:
        for side, p in procs.items():
            _, err = p.communicate(timeout=420)
            assert p.returncode == 0, f"{side}: {err[-3000:]}"
    finally:
        for p in procs.values():
            p.kill()
    return out


def _rel(want, got) -> float:
    scale = float(np.abs(want).max())
    err = float(np.abs(want - got).max())
    return err / scale if scale else err


def _close(want, got, rtol=LOSS_RTOL) -> bool:
    return abs(float(want) - float(got)) <= rtol * abs(float(want))


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_each_collective_backward_is_the_reference_transpose(runs, name):
    ref = np.load(runs / f"jax_coll_{name}.npz")
    for rank in range(WORLD):
        got = np.load(runs / f"torch_coll_{name}_{rank}.npz")
        assert np.array_equal(got["out"], ref["out"][rank]), rank
        assert np.array_equal(got["grad"], ref["grad"][rank]), rank


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_gradients_under_the_model_specs_match_the_reference(runs, name):
    """Every rank's out within 1e-5 of max |out| of its shard, rank 0's
    ``aux`` the reference's (mesh position (0, 0)), and every gradient
    (router, experts with the replica slots summed, shared experts, x)
    within 1e-4 of its tensor's max."""
    ref = np.load(runs / f"jax_moe_{name}.npz")
    data, model = CASES[name][0]
    bl = ref["x"].shape[0] // data
    drops = []
    for rank in range(WORLD):
        got = np.load(runs / f"torch_moe_{name}_{rank}.npz")
        r = rank // model
        assert _rel(ref["out"][r * bl:(r + 1) * bl], got["out"]) <= 1e-5
        assert _rel(ref["x"][r * bl:(r + 1) * bl], got["x"]) <= GRAD_TOL, rank
        params = [k for k in ref.files if k.startswith("param.")]
        assert set(params) == {k for k in got.files if k.startswith("param.")}
        for key in params:
            assert _rel(ref[key], got[key]) <= GRAD_TOL, (rank, key)
        drops.append(float(got["dropped"]))
    assert _close(ref["aux"], np.load(runs / f"torch_moe_{name}_0.npz")["aux"])
    assert max(drops) > 0  # tokens did drop


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_gradients_match_value_and_grad_on_every_rank(runs, name):
    ref = np.load(runs / f"jax_model_{name}.npz")
    grads = [k for k in ref.files if k.startswith("grad.")]
    worst = {}
    for rank in range(WORLD):
        got = np.load(runs / f"torch_model_{name}_{rank}.npz")
        assert set(grads) == {k for k in got.files if k.startswith("grad.")}
        for key in grads:
            worst[key] = max(worst.get(key, 0.0), _rel(ref[key], got[key]))
        assert _close(ref["nll"], got["nll"]) and _close(ref["loss"], got["loss"])
        assert _close(ref["aux"], got["aux"])
    assert max(worst.values()) <= GRAD_TOL, max(worst, key=worst.get)
    assert all(float(np.abs(ref[k]).max()) > 0 for k in grads)
    # capacity 1.25 drops tokens on some rank of the (4, 2) mesh
    if name == "deepseek":
        assert max(np.load(runs / f"torch_model_{name}_{r}.npz")["dropped"].max()
                   for r in range(WORLD)) > 0


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_one_adamw_step_leaves_every_rank_equal(runs, name):
    """``make_train_step`` reports the reference's loss on every rank, and
    every rank's parameters after the update equal rank 0's."""
    ref = np.load(runs / f"jax_model_{name}.npz")
    first = np.load(runs / f"torch_model_{name}_0.npz")
    params = [k for k in first.files if k.startswith("param.")]
    assert params
    for rank in range(WORLD):
        got = np.load(runs / f"torch_model_{name}_{rank}.npz")
        assert _close(ref["loss"], got["step.loss"]) and _close(ref["aux"], got["step.aux"])
        assert float(got["step.grad_norm"]) == float(first["step.grad_norm"])
        for key in params:
            assert np.array_equal(got[key], first[key]), (rank, key)
