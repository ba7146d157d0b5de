"""The one-card dry run (``repro_torch.launch.dryrun``) on the CPU.

- The meta trace is faithful: for the smoke config of each family (dense,
  MoE, SSM, hybrid, audio, VLM), with per-layer remat as the full configs
  have it, FlopCounterMode's total over a train, prefill and decode step
  on meta tensors equals the same step's total on CPU tensors, and the
  meta arguments' shapes and dtypes are those of the real ones.
- The count is the model's: a dense prefill's total equals the sum of its
  projections, the LM head and the einsum route's score and value
  products, written out below.
- The argument bytes of full-size cells equal the global bytes of the
  JAX package's specs (``jax.eval_shape`` of its ``init``, its
  ``input_specs``), less 4 B for each of JAX's 0-d int32 leaves (the
  cache's ``pos``, the train step's ``lag``: Python ints in the port).
- The CLI writes a cell's record (a subprocess, as tests/test_dryrun_e2e.py
  runs the JAX dry run), and refuses the card without one.

The JAX dry run itself (``repro.launch.dryrun``) is never imported here:
it sets ``XLA_FLAGS`` to 512 host devices at import, which would change
the device count of every later JAX test in the worker and of the
subprocesses it starts."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import shapes as jax_shapes
from repro.models import build_model as jax_build
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.fused_update.ops import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import ShapeSpec

ROOT = os.path.join(os.path.dirname(__file__), "..")
FAMILIES = {"dense": "qwen3-0.6b", "moe": "granite-moe-1b-a400m",
            "ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
            "audio": "whisper-large-v3", "vlm": "internvl2-76b"}
SMALL = {"train": ShapeSpec("small_train", 16, 4, "train"),
         "prefill": ShapeSpec("small_prefill", 16, 2, "prefill"),
         "decode": ShapeSpec("small_decode", 16, 2, "decode")}


def _smoke(arch, **over):
    return dataclasses.replace(get_smoke_config(arch), remat="full", **over)


def _flops_both(cfg, kind, microbatches=2):
    """(meta total, CPU total) of one step of ``kind`` at SMALL's shape."""
    spec, M = SMALL[kind], (microbatches if kind == "train" else 1)
    k_meta, meta = dryrun.meta_arguments(cfg, spec, M)
    k_cpu, real = dryrun.device_arguments(cfg, spec, M, device="cpu")
    assert k_meta == k_cpu == kind
    lm, lr = tree_leaves(meta), tree_leaves(real)
    assert len(lm) == len(lr)
    for a, b in zip(lm, lr):
        if torch.is_tensor(a):
            assert a.is_meta and b.device.type == "cpu"
            assert a.shape == b.shape and a.dtype == b.dtype
        else:
            assert a == b
    flops = []
    for args in (meta, real):
        total, _, _ = dryrun.count_flops(
            dryrun.make_step(cfg, kind, M, "reference"), args)
        flops.append(total)
    return flops


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_meta_trace_counts_what_the_cpu_counts(family):
    """The dense family runs the chunked route that production_config
    picks for the long train and prefill cells (with a ragged tail
    block); the MoE and VLM families keep the einsum route."""
    over = dict(attention_impl="chunked", attn_q_block=6) \
        if family == "dense" else {}
    cfg = _smoke(FAMILIES[family], **over)
    for kind in ("train", "prefill", "decode"):
        meta, cpu = _flops_both(cfg, kind)
        assert meta == cpu > 0, (family, kind, meta, cpu)


def test_dense_prefill_count_is_analytic():
    """qwen3's smoke prefill over B x S tokens on the einsum route: per
    layer the q, k, v and o projections, the SwiGLU MLP's three matmuls
    and the score and value products over the cache's S slots; then the
    LM head on the last position."""
    cfg = _smoke("qwen3-0.6b")
    spec = SMALL["prefill"]
    B, S = spec.global_batch, spec.seq_len
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T = B * S
    per_layer = (2 * T * D * H * hd            # q
                 + 2 * 2 * T * D * KV * hd     # k, v
                 + 2 * T * H * hd * D          # o
                 + 3 * 2 * T * D * F           # gate, up, down
                 + 2 * 2 * B * H * S * S * hd)  # scores, weights x values
    expected = cfg.num_layers * per_layer + 2 * B * D * V
    meta, cpu = _flops_both(cfg, "prefill")
    assert meta == cpu == expected


def _jax_argument_bytes(arch, shape):
    """Global bytes of the JAX cell's arguments, as its ``lower_cell``
    passes them, and the number of its 0-d int32 leaves."""
    cfg, _ = jax_shapes.production_config(jax_config(arch), shape)
    kind, kw = jax_shapes.input_specs(cfg, shape)
    params = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(params)
    if kind == "train":
        extra = [jax.ShapeDtypeStruct((), jnp.int32)]         # lag
        args = leaves + leaves + jax.tree.leaves(kw["batch"]) + extra
    else:
        args = [jax.ShapeDtypeStruct(l.shape, jnp.bfloat16)
                if l.dtype == jnp.float32 else l for l in leaves]
        args += jax.tree.leaves(kw["batch"]) + jax.tree.leaves(kw["cache"])
    total = sum(math.prod(l.shape) * np.dtype(l.dtype).itemsize for l in args)
    return total, sum(1 for l in args if l.shape == ())


@pytest.mark.parametrize("arch,shape,fits", [
    ("qwen3-0.6b", "decode_32k", False),
    ("mamba2-370m", "long_500k", None)])
def test_full_cell_record(arch, shape, fits):
    """A traced full-size serving cell: its argument bytes against JAX's
    specs, its output bytes (the greedy ids and the cache, written in
    place), fits_card, and the record's carried-over keys."""
    rec = dryrun.run_cell(arch, shape, device="meta")
    assert rec["status"] == "ok", rec.get("traceback")
    jax_bytes, n0 = _jax_argument_bytes(arch, shape)
    assert n0 == 1
    mem = rec["real"]["memory"]
    assert mem["argument_bytes"] == jax_bytes - 4 * n0
    cfg = get_config(arch)
    _, kw = dryrun.input_specs(cfg, shape)
    cache_bytes = dryrun.tree_bytes(kw["cache"])
    B = dryrun.SHAPES[shape].global_batch
    assert mem["output_bytes"] == cache_bytes + 8 * B
    assert rec["real"]["fits_card"] is fits
    assert rec["real"]["flops"] > 0 and "card" not in rec
    assert rec["model_flops"] == 2.0 * cfg.param_count() * B
    assert (rec["mesh"], rec["n_devices"], rec["microbatches"]) == \
        ("one_card", 1, 1)


def test_train_cell_argument_bytes():
    """granite-moe-1b-a400m x train_4k: f32 params, f32 momentum and the
    microbatched batch against JAX's specs (the arguments alone; the
    cell's whole trace takes about a minute on the CPU and runs in the
    census, not here)."""
    cfg, _ = dryrun.production_config(get_config("granite-moe-1b-a400m"),
                                      "train_4k")
    kind, args = dryrun.meta_arguments(cfg, "train_4k", 8)
    assert kind == "train" and args[3] == 1
    jax_bytes, n0 = _jax_argument_bytes("granite-moe-1b-a400m", "train_4k")
    assert n0 == 1
    assert dryrun.tree_bytes(args) == jax_bytes - 4
    assert dryrun.tree_bytes(args[0]) == 4 * cfg.param_count()


def test_cli_writes_the_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "long_500k", "--device", "meta",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "done: 1/1 cells ok" in out.stdout
    rec = json.load(open(tmp_path / "mamba2-370m__long_500k__one_card.json"))
    assert rec["status"] == "ok"
    assert rec["arch"] == "mamba2-370m" and rec["shape"] == "long_500k"
    assert rec["config_overrides"] == {}
    real = rec["real"]
    assert real["kind"] == "decode" and real["flops"] > 0
    assert real["memory"]["argument_bytes"] > 0
    assert set(real["memory"]) == {"argument_bytes", "output_bytes"}
    assert real["fits_card"] is None
    for dropped in ("mesh_shape", "calibrated", "update_epilogue"):
        assert dropped not in rec


def test_cli_cuda_without_a_card_raises(tmp_path):
    """``--device cuda`` (the default) raises before any cell runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
