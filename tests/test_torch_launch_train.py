"""``repro_torch.launch.train`` (the training driver), its CLI and the
training example ``examples/train_lm_torch.py``.

The reference's ``repro.launch.train`` does not import (its
``repro.dist`` is not in the tree), so its loop is composed here from the
reference's own pieces in the order of ``src/repro/launch/train.py:39-95``:
``build_model``, ``make_optimizer``, ``make_train_step``,
``write_token_file``, ``TokenLoader.batch_for_step``.  The port's driver
runs on the CPU from the same weights (the reference's ``init`` at
``PRNGKey(0)``, converted) in float32; each step's loss within 1e-3
relative (Adam's sign-like first steps let elements whose gradients sit
near zero move apart by 2 lr, so the parameters are not held elementwise).
"""

import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_train import one_torch_thread  # noqa: F401
from repro import configs as r_configs
from repro.data.loader import TokenLoader as RTokenLoader
from repro.data.loader import write_token_file as r_write_token_file
from repro.models.registry import build_model as r_build_model
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro.train.train_loop import make_train_step as r_make_train_step
from repro_torch import configs as p_configs
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import LMModel, convert

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-3


def _reference_losses(arch, steps, batch, seq, microbatches, lr):
    cfg = r_configs.reduced_config(arch)
    model = r_build_model(cfg, data_size=1, use_sharded_moe=False)
    params, _ = model.init(jax.random.PRNGKey(0))
    opt = r_make_optimizer(cfg.optimizer, lr=lr)
    opt_state = opt.init(params)
    step_fn = jax.jit(r_make_train_step(model, opt, microbatches=microbatches))
    init = jax.tree.map(np.asarray, params)
    fbytes = r_write_token_file(n_rows=max(64, batch * 4), seq_len=seq, vocab=cfg.vocab, seed=0)
    loader = RTokenLoader(fbytes, batch=batch, seq_len=seq, seed=0)
    losses = []
    try:
        for step in range(steps):
            b = {k: jnp.asarray(v) for k, v in loader.batch_for_step(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, b, jnp.int32(step))
            losses.append(float(metrics["loss"]))
    finally:
        loader.close()
    return init, losses


@pytest.mark.parametrize("arch,microbatches", [("smollm-360m", 1), ("grok-1-314b", 2)])
def test_train_matches_the_reference_loop(monkeypatch, arch, microbatches):
    name = f"{arch}-f32"
    for C in (r_configs, p_configs):
        monkeypatch.setitem(C.ARCHS, name,
                            dataclasses.replace(C.get_config(arch), name=name, dtype="float32"))
    steps, batch, seq, lr = 4, 4, 32, 1e-3
    init, want = _reference_losses(name, steps, batch, seq, microbatches, lr)

    def build_model(cfg, device=None, generator=None):
        model = LMModel(cfg, device=device)
        model.load_state_dict(convert.params_from_reference(cfg, init))
        return model

    got, real_make = [], launch_train.make_train_step

    def make_train_step(model, opt, **kw):
        step = real_make(model, opt, **kw)

        def recorded(*args):
            metrics = step(*args)
            got.append(float(metrics["loss"]))
            return metrics
        return recorded

    loaders, real_loader = [], launch_train.TokenLoader

    def token_loader(*args, **kw):
        loaders.append(real_loader(*args, **kw))
        return loaders[-1]

    monkeypatch.setattr(launch_train, "build_model", build_model)
    monkeypatch.setattr(launch_train, "make_train_step", make_train_step)
    ops.reset_counts()
    with monkeypatch.context() as m:
        m.setattr(launch_train, "TokenLoader", token_loader)
        loss, last = launch_train.train(name, steps=steps, batch=batch, seq=seq,
                                        microbatches=microbatches, lr=lr, device="cpu")
    assert last == steps and loss == got[-1] and len(got) == steps
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert want[-1] < want[0] and got[-1] < got[0]
    # the token file is read on the device route (the decode kernel's plain
    # version on the CPU, which counts no launch), with no fallback
    assert [ld.reader.decode for ld in loaders] == ["device"] and not ops.fallbacks


def test_train_refuses_what_the_reference_builds_on_repro_dist():
    for kw, item in (({"ckpt_dir": "ckpt"}, "repro.dist"), ({"ckpt_every": 5}, "repro.dist"),
                     ({"inject_failure_at": 2}, "repro.dist"),
                     ({"mesh_kind": "production"}, "repro.dist")):
        with pytest.raises(NotImplementedError, match=item):
            launch_train.train("smollm-360m", steps=1, device="cpu", **kw)
    with pytest.raises(ValueError, match="vision_embeds"):
        launch_train.train("llama-3.2-vision-90b", steps=1, device="cpu")


def test_cli(capsys):
    launch_train.main(["--steps", "2", "--batch", "2", "--seq", "16", "--lr", "1e-3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss=" in out and "[train] done at step 1, final loss" in out
    for flags, item in ((["--mesh", "production"], "repro.dist"),
                        (["--ckpt-dir", "x"], "repro.dist")):
        with pytest.raises(NotImplementedError, match=item):
            launch_train.main(["--steps", "1", "--device", "cpu", *flags])


def test_cli_runs_as_a_module():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-780m", "--steps",
         "1", "--batch", "2", "--seq", "16", "--device", "cpu"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "[train] done at step 0" in res.stdout


def test_example_trains_its_narrowed_config_scaled_down(monkeypatch):
    """The example's ~100M config, and its run at a width the CPU test can
    take (2 layers of 64, vocab 512): losses finite, the config registered."""
    spec = importlib.util.spec_from_file_location("train_lm_torch",
                                                  ROOT / "examples" / "train_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    from repro_torch.models.registry import param_counts

    cfg = example.smollm_100m()
    want = dataclasses.replace(r_configs.get_config("smollm-360m"), name="smollm-100m",
                               n_layers=12, d_model=512, d_ff=1536, n_heads=8, n_kv_heads=4,
                               head_dim=64, vocab=32768)  # examples/train_lm.py's narrowing
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert param_counts(cfg)[0] == 54_525_952
    monkeypatch.setattr(p_configs, "ARCHS", dict(p_configs.ARCHS))
    small = dataclasses.replace(cfg, name="smollm-100m-scaled", n_layers=2, d_model=64, d_ff=128,
                                n_heads=4, n_kv_heads=2, head_dim=16, vocab=512)
    loss, last = example.run(small, steps=2, batch=2, seq=16, device="cpu")
    assert np.isfinite(loss) and last == 2 and "smollm-100m-scaled" in p_configs.ARCHS
