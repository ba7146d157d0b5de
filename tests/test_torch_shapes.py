"""The port's LM cells (``repro_torch.launch.shapes``, ``launch.flops``,
the registry's ``ARCHS`` / ``all_arch_ids``) against the JAX package's,
for all 32 (arch, shape) cells: applicability, production overrides,
every leaf of ``input_specs`` (key path, shape, dtype), model FLOPs and
parameter counts, exactly.

Of the JAX launch layer this file imports ``repro.launch.shapes`` and
``repro.launch.flops`` only. ``repro.launch.dryrun`` and
``repro.launch.hillclimb`` set ``XLA_FLAGS`` to 512 host devices when
they are imported: inside a test worker that would change the device
count of every later JAX test in the process, and of every subprocess it
starts.

The JAX cache's ``pos`` is a 0-d int32 leaf; the port's is a Python int
(its models carry the position so), so that leaf is checked on the JAX
side and left out of the leaf-for-leaf comparison."""
import dataclasses

import jax
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import flops as jax_flops
from repro.launch import shapes as jax_shapes
from repro_torch import configs
from repro_torch.launch import flops, shapes


def _cells():
    return [(a, s) for a in configs.all_arch_ids() for s in shapes.SHAPES
            if shapes.applicable(configs.get_config(a), s)]


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [l for k in sorted(tree)
                for l in _port_leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _jax_leaves(tree):
    return sorted((tuple(k.key for k in path), leaf) for path, leaf in
                  jax.tree_util.tree_leaves_with_path(tree))


def test_registry_equals_jax():
    assert configs.ARCHS == jax_configs.ARCHS
    assert configs.all_arch_ids() == jax_configs.all_arch_ids()
    for a in configs.all_arch_ids():
        assert dataclasses.asdict(configs.get_config(a)) == \
            dataclasses.asdict(jax_configs.get_config(a)), a


def test_cell_count_is_32():
    assert len(_cells()) == 32
    assert [c for c in _cells()] == [
        (a, s) for a in jax_configs.all_arch_ids() for s in jax_shapes.SHAPES
        if jax_shapes.applicable(jax_configs.get_config(a), s)]


def test_constants_equal_jax():
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == \
        {k: vars(v) for k, v in jax_shapes.SHAPES.items()}
    assert shapes.TRAIN_MICROBATCHES == jax_shapes.TRAIN_MICROBATCHES
    assert shapes.FSDP_ARCHS == jax_shapes.FSDP_ARCHS
    assert shapes.FSDP_SERVE_ARCHS == jax_shapes.FSDP_SERVE_ARCHS


@pytest.mark.parametrize("arch", jax_configs.all_arch_ids())
def test_input_specs_equal_jax(arch):
    """Each cell of ``arch``: the overrides, the kind and every leaf of
    the step's inputs; every port leaf is a meta tensor."""
    for shape in shapes.SHAPES:
        cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
        assert shapes.applicable(cfg, shape) == \
            jax_shapes.applicable(jcfg, shape)
        if not shapes.applicable(cfg, shape):
            continue
        cfg, over = shapes.production_config(cfg, shape)
        jcfg, jover = jax_shapes.production_config(jcfg, shape)
        assert over == jover, (arch, shape)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        kind, kw = shapes.input_specs(cfg, shape)
        jkind, jkw = jax_shapes.input_specs(jcfg, shape)
        assert kind == jkind
        mine = _port_leaves(kw)
        theirs = _jax_leaves(jkw)
        if kind != "train":
            assert kw["cache"]["pos"] == 0
            pos = [l for p, l in theirs if p == ("cache", "pos")]
            assert len(pos) == 1 and pos[0].shape == () and \
                pos[0].dtype == "int32"
            mine = [(p, l) for p, l in mine if p != ("cache", "pos")]
            theirs = [(p, l) for p, l in theirs if p != ("cache", "pos")]
        assert [p for p, _ in mine] == [p for p, _ in theirs], (arch, shape)
        for (path, t), (_, j) in zip(mine, theirs):
            assert t.is_meta, (arch, shape, path)
            assert tuple(t.shape) == tuple(j.shape), (arch, shape, path)
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype), \
                (arch, shape, path)


@pytest.mark.parametrize("arch", jax_configs.all_arch_ids())
def test_model_flops_and_counts_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for shape in shapes.SHAPES:
        if shapes.applicable(cfg, shape):
            pcfg, _ = shapes.production_config(cfg, shape)
            jpcfg, _ = jax_shapes.production_config(jcfg, shape)
            assert flops.model_flops(pcfg, shape) == \
                jax_flops.model_flops(jpcfg, shape), (arch, shape)


def test_microbatch_and_shape_spec_arguments():
    """``input_specs`` with an explicit microbatch count and a ShapeSpec,
    as the JAX function takes them."""
    cfg = configs.get_config("qwen3-0.6b")
    spec = shapes.ShapeSpec("small", 64, 8, "train")
    _, kw = shapes.input_specs(cfg, spec, microbatches=1)
    assert tuple(kw["batch"]["tokens"].shape) == (8, 64)
    _, kw = shapes.input_specs(cfg, "train_4k", microbatches=4)
    assert tuple(kw["batch"]["labels"].shape) == (4, 64, 4096)
    assert kw["batch"]["labels"].dtype == torch.int32
