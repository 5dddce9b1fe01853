"""The port's dry-run specs as plain data, against the JAX package's.

* ``input_specs`` and ``cache_specs(dp_total=16)`` on every ``ARCHS`` x
  ``SHAPES`` cell that ``supports_shape`` allows (the grid of the reference's
  ``tests/test_models.py::test_input_and_cache_specs_constructible``):
  shapes, dtypes and axes equal to the reference's ``ShapeDtypeStruct``
  leaves and ``tuple(PartitionSpec)``, over equal tree structures;
* ``param_specs(cfg, data_size)`` per arch, equal to the spec tree and the
  abstract params of the reference's ``LMModel.init`` under
  ``jax.eval_shape`` (the reference's ``launch/dryrun.abstract_init``, which
  cannot be imported: it needs ``repro.dist``);
* ``adamw`` and ``adafactor`` ``state_specs`` on those trees;
* at ``data_size=1`` the specs describe the port's own module leaf for leaf
  (``convert.stacked_leaves``), and ``TensorSpec.meta()`` allocates nothing.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import SHAPES as R_SHAPES
from repro.models.registry import build_model as r_build_model
from repro.models.registry import cache_specs as r_cache_specs
from repro.models.registry import input_specs as r_input_specs
from repro.train.optimizer import make_optimizer as r_make_optimizer
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced_config
from repro_torch.models import LMModel, convert
from repro_torch.models.common import TensorSpec
from repro_torch.models.registry import cache_specs, input_specs, param_specs, supports_shape
from repro_torch.train.optimizer import make_optimizer

CELLS = [(a, s) for a in ARCHS for s in SHAPES if supports_shape(get_config(a), SHAPES[s])[0]]
MOE_ARCHS = [a for a in ARCHS if get_config(a).moe is not None]


def abstract_init(model, seed: int = 0):
    """(ShapeDtypeStruct params, specs) without allocating anything: the
    reference's ``launch/dryrun.abstract_init``."""
    captured = {}

    def f(key):
        p, s = model.init(key)
        captured["specs"] = s
        return p

    shapes = jax.eval_shape(f, jax.random.PRNGKey(seed))
    return shapes, captured["specs"]


@functools.lru_cache(maxsize=None)
def reference_params(arch: str, data_size: int = 16):
    return abstract_init(r_build_model(r_get_config(arch), data_size=data_size))


def ref_flat(tree):
    """{path: leaf} of a reference tree: a ShapeDtypeStruct as (shape, dtype
    name), a PartitionSpec as its tuple."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: not isinstance(s, dict))
    out = {}
    for path, leaf in flat:
        key = tuple(p.key for p in path)
        if isinstance(leaf, jax.ShapeDtypeStruct):
            out[key] = (tuple(leaf.shape), str(leaf.dtype))
        else:
            out[key] = tuple(leaf)
    return out


def port_flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(port_flat(v, prefix + (k,)))
        elif isinstance(v, TensorSpec):
            out[prefix + (k,)] = (v.shape, str(v.dtype).removeprefix("torch."))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_cache_specs_equal_the_reference(arch, shape):
    rcfg, pcfg = r_get_config(arch), get_config(arch)
    rs, ps = R_SHAPES[shape], SHAPES[shape]
    want, got = r_input_specs(rcfg, rs), input_specs(pcfg, ps)
    assert set(want) == set(got)
    for name, (sds, spec) in want.items():
        t, axes = got[name]
        assert (t.shape, str(t.dtype).removeprefix("torch.")) == (tuple(sds.shape), str(sds.dtype))
        assert axes == tuple(spec)
    if ps.kind == "decode":
        r_shapes, r_axes = r_cache_specs(rcfg, rs, dp_total=16)
        p_shapes, p_axes = cache_specs(pcfg, ps, dp_total=16)
        assert port_flat(p_shapes) == ref_flat(r_shapes)
        assert port_flat(p_axes) == ref_flat(r_axes)
        assert set(port_flat(p_shapes)) == set(port_flat(p_axes))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_the_reference_init(arch):
    r_shapes, r_axes = reference_params(arch)
    shapes, axes = param_specs(get_config(arch), data_size=16)
    assert port_flat(shapes) == ref_flat(r_shapes)
    assert port_flat(axes) == ref_flat(r_axes)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("data_size", [1, 4, 64])
def test_param_specs_tile_experts_as_the_reference(arch, data_size):
    r_shapes, r_axes = reference_params(arch, data_size)
    shapes, axes = param_specs(get_config(arch), data_size=data_size)
    assert port_flat(shapes) == ref_flat(r_shapes)
    assert port_flat(axes) == ref_flat(r_axes)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_specs_equal_the_reference(arch, name):
    _, r_axes = reference_params(arch)
    _, axes = param_specs(get_config(arch))
    want = r_make_optimizer(name).state_specs(r_axes)
    assert port_flat(make_optimizer(name).state_specs(axes)) == ref_flat(want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_describe_the_module_at_data_size_1(arch):
    """With one expert slot per expert the spec tree is the port's module,
    stacked: every reference leaf's shape is its stack shape plus the
    per-layer parameter's, in the parameter's dtype."""
    cfg = reduced_config(arch)
    shapes, _ = param_specs(cfg, data_size=1)
    params = dict(LMModel(cfg, device="cpu").named_parameters())
    leaves = convert.stacked_leaves(params)
    flat = {".".join(k): v for k, v in port_flat(shapes).items()}
    assert set(flat) == set(leaves)
    for path, (stack, names) in leaves.items():
        p = params[names[0]]
        assert flat[path] == (stack + tuple(p.shape), str(p.dtype).removeprefix("torch."))


def test_meta_allocates_nothing():
    """Every leaf of the largest model's specs, and a 4 TiB tensor, on the
    meta device: the spec's shape and dtype, and no memory behind them
    (a storage on the meta device with a null data pointer)."""
    shapes, _ = param_specs(get_config("llama-3.2-vision-90b"))
    leaves = list(port_flat(shapes).items())
    for _, (shape, dtype) in leaves:
        assert isinstance(shape, tuple) and dtype in ("bfloat16", "float32")
    total = 0
    for spec in _walk(shapes):
        t = spec.meta()
        assert t.is_meta and t.shape == spec.shape and t.dtype == spec.dtype
        total += t.numel()
    assert total > 80e9
    huge = TensorSpec((1 << 40,), torch.float32).meta()
    storage = huge.untyped_storage()
    assert huge.is_meta and storage.device.type == "meta" and storage.data_ptr() == 0
    assert np.prod(huge.shape) == 1 << 40


def _walk(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _walk(v)
        else:
            yield v
