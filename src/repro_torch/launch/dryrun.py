"""One-card dry run of the LM cells — the counterpart of ``run_cell`` and
``main`` of ``repro/launch/dryrun.py``.

Per (arch, shape) cell, one JSON record ``{arch}__{shape}__one_card.json``:

- ``real``: one whole step at the cell's production shape
  (``launch/shapes.py``), traced on meta tensors, so no card and no memory
  are needed: the train step with all ``microbatches`` and the
  fused-update epilogue, or one prefill, or one decode step (the last
  position of a ``seq_len`` context), with ``kernel="reference"``.
  ``flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s total over
  that step (matmul-class operations: it counts no elementwise work) and
  ``flops_by_op`` its split. The eager trace runs every layer and every
  microbatch, so the count needs no calibration (the JAX dry run
  extrapolates from unrolled 2- and 3-layer compiles because XLA counts a
  while-loop body once). ``memory`` holds ``argument_bytes`` and
  ``output_bytes``, summed from the tensors themselves: train arguments
  are the f32 params, the f32 momentum and the batch; serving arguments
  the params cast to bf16 (as the JAX ``lower_cell`` casts them), the
  batch and the cache. Outputs count every tensor the step returns, the
  cache included, which is the argument's own storage (prefill and decode
  write it in place, as JAX donates it). A meta trace measures no
  temporaries, so the record states none. ``fits_card`` is ``false``
  where the arguments alone exceed ``CARD_BYTES``, else ``null``
  (unmeasured).
- ``card``: only for the cells of ``CARD_CELLS`` with ``device="cuda"``:
  the same step on the card (parameters drawn on the card from seed 0,
  the decode caches filled with normal draws), after one warm-up step:
  ``argument_bytes`` of the card's tensors, ``peak_bytes``
  (``torch.cuda.max_memory_allocated`` around the timed step), ``step_ms``
  (CUDA events), ``fits_card`` (the peak within ``CARD_BYTES``), the
  FLOPs ``FlopCounterMode`` counts in a third step (the hand kernels are
  not aten operations: K3's share of a prefill is not among them), the
  card's name and power limit, and the hand kernels each launched in the
  timed step.

The JAX record's ``mesh_shape``, ``calibrated``, ``update_epilogue``,
``hbm_bytes``, ``attn_quad_bytes``, ``ssd_quad_bytes``, ``collectives``
and ``collective_group_sizes`` describe XLA compiles on TPU meshes and
have no one-card meaning; the record leaves them out.

    python -m repro_torch.launch.dryrun --all --device meta --out DIR
    python -m repro_torch.launch.dryrun --arch mamba2-370m \\
        --shape prefill_32k --out DIR              # on the card
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import all_arch_ids, get_config
from ..device import card_line, resolve_device
from ..kernels.fused_update.ops import tree_leaves, tree_map
from ..models import build_model
from ..models.zoo import param_specs
from .flops import model_flops
from .shapes import (SHAPES, TRAIN_MICROBATCHES, applicable, input_specs,
                     production_config)
from .steps import make_decode_step, make_prefill_step, make_train_step

# the serving cells whose arguments fit the card (their train cells are
# not run: one microbatch's f32 logits alone would take tens of GB)
CARD_CELLS = (("mamba2-370m", "prefill_32k"), ("mamba2-370m", "decode_32k"),
              ("mamba2-370m", "long_500k"), ("zamba2-2.7b", "long_500k"))
CARD_BYTES = 75 * 2 ** 30     # the share of the H100's 80 GB a cell may take


def cells(archs, shapes):
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            if applicable(cfg, s):
                yield a, s


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if torch.is_tensor(t))


def make_step(cfg, kind: str, microbatches: int, kernel: str):
    if kind == "train":
        return make_train_step(cfg, microbatches=microbatches, kernel=kernel)
    if kind == "prefill":
        return make_prefill_step(cfg, kernel=kernel)
    return make_decode_step(cfg, kernel=kernel)


def _assemble(kind, spec, params, batch, cache):
    """The step's positional arguments: train (params, f32 momentum, batch,
    lag 1); prefill (bf16 params, batch, cache); decode (bf16 params, the
    cache at position ``seq_len - 1``, batch)."""
    if kind == "train":
        v = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return (params, v, batch, 1)
    params = tree_map(lambda p: p.to(torch.bfloat16)
                      if p.dtype == torch.float32 else p, params)
    if kind == "prefill":
        return (params, batch, cache)
    return (params, dict(cache, pos=spec.seq_len - 1), batch)


def _spec(shape):
    return SHAPES[shape] if isinstance(shape, str) else shape


def meta_arguments(cfg, shape, microbatches: int):
    """(kind, the step's arguments as meta tensors). ``shape``: a shape
    name or a ShapeSpec."""
    spec = _spec(shape)
    kind, kw = input_specs(cfg, spec, microbatches=microbatches)
    return kind, _assemble(kind, spec, param_specs(cfg), kw["batch"],
                           kw.get("cache"))


def device_arguments(cfg, shape, microbatches: int, device="cuda"):
    """(kind, the step's arguments on ``device``): the parameters from
    ``init`` on a generator of that device seeded with 0, the cache
    from ``init_cache`` (a decode cache then filled with normal draws),
    token ids uniform over the vocabulary and normal frontend embeddings
    drawn in the batch's meta shapes."""
    dev = resolve_device(device)
    spec = _spec(shape)
    kind, kw = input_specs(cfg, spec, microbatches=microbatches)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg)
    params = model.init(gen, device=dev)
    cache = None
    if kind != "train":
        cache = model.init_cache(spec.global_batch, spec.seq_len, device=dev)
        if kind == "decode":
            for t in tree_leaves(cache):
                if torch.is_tensor(t):
                    t.normal_(generator=gen)

    def draw(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             device=dev, dtype=t.dtype)

    batch = {k: draw(t) for k, t in kw["batch"].items()}
    return kind, _assemble(kind, spec, params, batch, cache)


def count_flops(step, args):
    """(FlopCounterMode's total over one call of ``step``, its split by
    operation, the call's outputs)."""
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    by_op = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
    return fc.get_total_flops(), by_op, out


def trace_cell(cfg, shape: str, microbatches: int) -> dict:
    """The ``real`` record: one step traced on meta tensors."""
    t0 = time.perf_counter()
    kind, args = meta_arguments(cfg, shape, microbatches)
    flops, by_op, out = count_flops(
        make_step(cfg, kind, microbatches, "reference"), args)
    arg_bytes = tree_bytes(args)
    return {"kind": kind, "flops": flops, "flops_by_op": by_op,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": tree_bytes(out)},
            "fits_card": False if arg_bytes > CARD_BYTES else None,
            "trace_s": time.perf_counter() - t0}


def launch_counters():
    """The hand kernels' launch counters: {name: wrapper}."""
    from ..kernels.flash_attention import flash_attention_cuda
    from ..kernels.fused_update import (fused_apply_triton,
                                        fused_update_triton)
    from ..kernels.ssd_scan import ssd_intra_chunk_cuda
    return {"K1 fused_apply_cohort": fused_apply_triton,
            "K2 fused_update": fused_update_triton,
            "K3 ssd_intra_chunk": ssd_intra_chunk_cuda,
            "K4 flash_attention": flash_attention_cuda}


def card_cell(cfg, shape: str, microbatches: int) -> dict:
    """The ``card`` record: the cell's step on the card (hand kernels on),
    one warm-up step, one timed step, one step under FlopCounterMode."""
    dev = resolve_device("cuda")
    torch.cuda.empty_cache()
    kind, args = device_arguments(cfg, shape, microbatches, dev)
    step = make_step(cfg, kind, microbatches, "auto")
    step(*args)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counters = launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = step(*args)
    end.record()
    torch.cuda.synchronize(dev)
    launches = {k: f.launches - before[k] for k, f in counters.items()
                if f.launches > before[k]}
    rec = {"argument_bytes": tree_bytes(args),
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "step_ms": start.elapsed_time(end),
           "output_ok": _output_ok(cfg, kind, out[-1] if kind == "train"
                                   else out[0]),
           "card": card_line(),
           "kernels": launches}
    rec["fits_card"] = rec["peak_bytes"] <= CARD_BYTES
    del out
    rec["flops"], _, _ = count_flops(step, args)
    return rec


def _output_ok(cfg, kind, out) -> bool:
    """Finite loss and gap (train), finite logits (prefill), token ids in
    the vocabulary (decode)."""
    if kind == "train":
        return all(bool(torch.isfinite(t).all()) for t in out.values())
    if kind == "prefill":
        return bool(torch.isfinite(out).all())
    return bool(((out >= 0) & (out < cfg.vocab_size)).all())


def run_cell(arch: str, shape: str, out_dir: str | None = None, *,
             device: str = "cuda") -> dict:
    """One cell's record (written to ``out_dir`` when given). ``device``:
    ``"meta"`` traces only; ``"cuda"`` also runs the cell on the card when
    it is one of ``CARD_CELLS``. An error is recorded with its traceback,
    as the JAX dry run records it."""
    cfg, applied = production_config(get_config(arch), shape)
    spec = SHAPES[shape]
    M = TRAIN_MICROBATCHES if spec.kind == "train" else 1
    rec = {"arch": arch, "shape": shape, "mesh": "one_card",
           "config_overrides": applied, "n_devices": 1, "microbatches": M,
           "param_count": int(cfg.param_count()),
           "active_param_count": int(cfg.active_param_count()),
           "model_flops": model_flops(cfg, shape), "status": "ok"}
    try:
        rec["real"] = trace_cell(cfg, shape, M)
        if device == "cuda" and (cfg.name, shape) in CARD_CELLS:
            rec["card"] = card_cell(cfg, shape, M)
    except Exception as e:      # the record carries it; the census goes on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape}__one_card.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def summary(rec, seconds: float) -> str:
    real = rec.get("real", {})
    gib = real.get("memory", {}).get("argument_bytes", 0) / 2 ** 30
    flops = real.get("flops", 0)
    line = (f"[{rec['status']:5s}] {rec['arch']:22s} {rec['shape']:12s} "
            f"{seconds:7.1f}s args={gib:8.2f}GiB flops={flops:.6e} "
            f"model_flops={rec['model_flops']:.6e} "
            f"fits_card={real.get('fits_card')}")
    card = rec.get("card")
    if card:
        line += (f" card: peak={card['peak_bytes'] / 2 ** 30:.2f}GiB "
                 f"step_ms={card['step_ms']:.3f} kernels={card['kernels']}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"])
    args = ap.parse_args(argv)
    if not (args.all or args.arch):
        ap.error("pass --arch or --all")
    if args.device == "cuda":
        resolve_device("cuda")
    archs = [args.arch] if args.arch else all_arch_ids()
    shapes = [args.shape] if args.shape else list(SHAPES)
    n = n_err = 0
    t_all = time.perf_counter()
    for arch, shape in cells(archs, shapes):
        t0 = time.perf_counter()
        rec = run_cell(arch, shape, args.out, device=args.device)
        print(summary(rec, time.perf_counter() - t0), flush=True)
        if rec["status"] == "error":
            print(rec["error"], flush=True)
        n, n_err = n + 1, n_err + (rec["status"] != "ok")
    print(f"done: {n - n_err}/{n} cells ok in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
