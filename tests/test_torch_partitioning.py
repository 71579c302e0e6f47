"""The port's spec trees and placements against the JAX package's: for
every arch of the port's registry, full and smoke, ``param_specs``,
``train_state_specs`` (plain and factored AdamW) and ``quantized_specs``
equal the reference's trees, and ``spec_for`` / ``to_shardings`` under
``param_rules`` equal the reference's ``spec_for`` leaf by leaf on four
meshes given by shape alone (the reference's ``sanitize_spec`` reads only
``mesh.shape``).  Full-width shapes come from ``jax.eval_shape``; the
port's optimizer state is made on the meta device, so no full-width
tensor is allocated.  The port-only cuts of Jamba compare against the
reference's Jamba tree (the same modules; the cut changes depth and the
held experts, not the axes), their placements against the reference's
``spec_for`` on the port's own shapes.  All exact."""
import dataclasses
import functools

import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.quantize import quantized_specs as jax_quantized_specs
from repro.nn import partitioning as jax_part
from repro.nn import transformer as jax_T
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train.step import train_state_specs as jax_train_state_specs
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core.quantize import quantized_specs
from repro_torch.nn import partitioning as part
from repro_torch.nn import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.train.step import train_state_specs


class ShapeMesh:
    """A mesh given by its axis sizes alone."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {"data2": ShapeMesh(data=2, model=1),
          "data4_model2": ShapeMesh(data=4, model=2),
          "data16_model16": ShapeMesh(data=16, model=16),
          "pod2_data16_model16": ShapeMesh(pod=2, data=16, model=16)}
BASE = {"jamba-1.5-large-398b-1chip": "jamba-1.5-large-398b",
        "jamba-1.5-large-398b-train-1chip": "jamba-1.5-large-398b"}


def _cfgs(arch, smoke):
    cfg = get_config(arch)
    ref = jax_get_config(BASE.get(arch, arch))
    if arch in BASE:
        ref = dataclasses.replace(ref, n_layers=cfg.n_layers,
                                  block_pattern=cfg.block_pattern)
    if smoke:
        cfg, ref = smoke_config(cfg), jax_smoke_config(ref)
    return cfg, ref


@functools.lru_cache(maxsize=None)
def _reference(arch, smoke):
    """The reference's (param shapes, specs) from ``jax.eval_shape``."""
    _, ref = _cfgs(arch, smoke)
    box = {}

    def init(key):
        params, specs = jax_T.init_lm(key, ref)
        box["specs"] = specs
        return params
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, box["specs"]


def _meta(cfg, ref_shapes, arch):
    """The port's params on the meta device (``init_lm(device="meta")``):
    shapes only; for an arch of the reference's registry they must be the
    reference's shapes."""
    params = T.init_lm(cfg, device="meta")
    if arch not in BASE:
        jax.tree.map(lambda p, s: (tuple(p.shape) == tuple(s.shape)) or
                     pytest.fail(f"{tuple(p.shape)} vs {s.shape}"),
                     params, ref_shapes)
    return params


def _placements_ref(spec_tree, shape_tree, rules, mesh):
    is_spec = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        a is None or isinstance(a, str) for a in x)
    return jax.tree.map(
        lambda s, shp: tuple(jax_part.spec_for(s, tuple(shp.shape), rules,
                                               mesh)),
        spec_tree, shape_tree, is_leaf=is_spec)


def _states(cfg, ref, params, ref_shapes):
    """(port opt state on meta, reference opt state shapes) for plain and
    factored AdamW."""
    out = []
    for factored in (False, True):
        opt = AdamW(factored=factored)
        jopt = JaxAdamW(factored=factored)
        out.append((opt.init(params),
                    jax.eval_shape(jopt.init, ref_shapes)))
    return out


ARCHS = list_archs()


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(arch, smoke):
    cfg, ref = _cfgs(arch, smoke)
    ref_shapes, ref_specs = _reference(arch, smoke)
    specs = T.param_specs(cfg)
    assert specs == ref_specs
    params = _meta(cfg, ref_shapes, arch)
    # the spec tree covers init's tree leaf for leaf, rank for rank
    jax.tree.map(lambda s, p: (len(s) == p.dim()) or pytest.fail(
        f"{s} vs {tuple(p.shape)}"), specs, params,
        is_leaf=lambda x: isinstance(x, tuple))
    for (opt_state, ref_opt) in _states(cfg, ref, params, ref_shapes):
        got = train_state_specs(specs, opt_state)
        want = jax_train_state_specs(ref_specs, ref_opt)
        assert got == want
    if arch not in BASE:
        assert quantized_specs(specs, params) == \
            jax_quantized_specs(ref_specs, ref_shapes)
        assert quantized_specs(specs, params, min_size=1 << 40) == specs


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_reference(arch, mesh):
    """``to_shardings`` of the params and of the factored train state
    under ``param_rules(fsdp=cfg.fsdp)``, full and smoke, equal the
    reference's ``spec_for`` on the same shapes, on each mesh; under FSDP
    on a data axis "embed" lands there wherever it divides."""
    m = MESHES[mesh]
    for smoke in (False, True):
        cfg, ref = _cfgs(arch, smoke)
        ref_shapes, ref_specs = _reference(arch, smoke)
        params = _meta(cfg, ref_shapes, arch)
        specs = T.param_specs(cfg)
        for fsdp in {cfg.fsdp, True}:
            rules = part.param_rules(fsdp=fsdp, mesh=m)
            assert rules == jax_part.param_rules(fsdp=fsdp, mesh=m)
            got = part.to_shardings(specs, params, rules, m)
            assert got == _placements_ref(specs, params, rules, m)
            opt_state = AdamW(factored=True).init(params)
            st_specs = train_state_specs(specs, opt_state)
            shapes = {"params": params, "opt": opt_state,
                      "step": torch.empty((), device="meta")}
            assert part.to_shardings(st_specs, shapes, rules, m) == \
                _placements_ref(st_specs, shapes, rules, m)
            if fsdp and "pod" not in m.shape:
                assert got["final_norm"] == ("data",)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sanitize_and_batch_spec_equal_the_reference(mesh):
    m = MESHES[mesh]
    cases = [(("data", "model"), (64, 48)), ((("pod", "data"), None), (96, 3)),
             (("data", "data"), (32, 32)), ((("data", "model"), "model"),
                                            (512, 256)),
             ((None, "model"), (7, 5)), (("model", ("pod", "data")),
                                         (16, 33))]
    for axes, shape in cases:
        axes = tuple(a if a is None or isinstance(a, str) or
                     all(x in m.shape for x in a) else a[-1:] for a in axes)
        if any(isinstance(a, str) and a not in m.shape for a in axes):
            continue
        assert part.sanitize_spec(axes, shape, m) == \
            tuple(jax_part.sanitize_spec(axes, shape, m))
    for batch in (1, 2, 3, 16, 32, 48, 64, 512):
        assert part.batch_spec(batch, m) == tuple(jax_part.batch_spec(
            batch, m))
        assert part.batch_spec(batch, m, trailing=(None, None)) == \
            tuple(jax_part.batch_spec(batch, m, trailing=(None, None)))
    assert part.batch_axes(m) == jax_part.batch_axes(m)
    for profile in ("tp", "ddp", "ep"):
        for fsdp in (False, True):
            assert part.param_rules(fsdp=fsdp, mesh=m, profile=profile) == \
                jax_part.param_rules(fsdp=fsdp, mesh=m, profile=profile)


def test_a_dim_that_does_not_divide_stays_whole():
    m = ShapeMesh(data=3, model=1)
    rules = part.param_rules(fsdp=True, mesh=m)
    assert part.spec_for(("vocab", "embed"), (256, 64), rules, m) == \
        ("model", None)
    assert part.spec_for(("vocab", "embed"), (256, 63), rules, m) == \
        ("model", "data")
    assert part.spec_for(("layers", "embed", "heads"), (2, 66, 64), rules,
                         m) == (None, "data", "model")


def test_mesh_shape_reads_a_device_mesh_and_a_mapping():
    dm = type("DM", (), {"mesh_dim_names": ("data", "model"),
                         "shape": (4, 1)})()
    assert part.mesh_shape(dm) == {"data": 4, "model": 1}
    assert part.mesh_shape(ShapeMesh(data=2, model=1)) == \
        {"data": 2, "model": 1}
