"""Serving launcher: batched prefill + decode — the port of
``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 16 --prompt-len 32 --gen-len 24

Runs a small request pool through prefill → token-by-token decode with a
shared decode step, reporting throughput.  ``--arch`` takes every
config of :mod:`repro_torch.configs` (``deepseek-v3-671b``,
``jamba-1.5-large-398b``, ``rwkv6-7b``, ...; smoke-sized); an
encoder-decoder is fed constant encoder features, as the reference's
launcher feeds them.  With ``--coded``
the same model is served through the coded-computation bridge
(:mod:`repro_torch.serve_coded`): the output-head matmul of every token
batch (``--coding-scope ffn|trunk``: also the FFN / every trunk
projection) is MDS-encoded and executed as per-worker shards scheduled by
the stream planner, the shard products on ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve --coded --policy edf \
        --requests 12 --gen-len 8

``--device`` picks the torch device (default ``cuda``; ``cpu`` runs the
plain-torch path).  The building blocks (``build_model`` /
``serving_fns`` / ``zero_caches`` / ``head_matrix``) are shared with the
bridge so both paths serve the exact same model.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

__all__ = ["build_model", "serving_fns", "zero_caches", "head_matrix",
           "main"]


_MODEL_CACHE: dict = {}


def build_model(arch: str, *, smoke: bool = True, seed: int = 0,
                device=None):
    """Config + initialised parameters for ``arch`` (smoke-sized or full)
    on ``device`` (default ``cuda``).

    Memoised per (arch, smoke, seed, device): init is deterministic and
    params are read-only everywhere, so repeated bridge/test construction
    shares one copy instead of re-initialising the model."""
    from ..configs import get_config, get_smoke_config
    from ..device import resolve_device
    from ..models import init_model
    dev = resolve_device(device)
    key = (arch, bool(smoke), int(seed), str(dev))
    if key not in _MODEL_CACHE:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        _MODEL_CACHE[key] = (cfg, init_model(seed, cfg, dev))
    return _MODEL_CACHE[key]


def serving_fns(cfg, *, return_hidden: bool = False):
    """(prefill_fn, decode_fn) closures over ``cfg``, run under
    ``torch.inference_mode``.  ``return_hidden`` threads the final-norm
    hidden states out of both — the input the coded output head
    distributes across workers."""
    from ..models import decode_step, prefill

    @torch.inference_mode()
    def prefill_fn(p, b, c):
        return prefill(p, b, c, cfg=cfg, return_hidden=return_hidden)

    @torch.inference_mode()
    def decode_fn(p, t, pos, c):
        return decode_step(p, t, pos, c, cfg=cfg,
                           return_hidden=return_hidden)

    return prefill_fn, decode_fn


def zero_caches(cfg, batch: int, max_len: int, device=None):
    """Zero-initialised decode caches for ``batch`` slots on ``device``."""
    from ..device import resolve_device
    from ..models import init_cache_shapes
    dev = resolve_device(device)

    def make(tree):
        if isinstance(tree, dict):
            return {k: make(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [make(v) for v in tree]
        shape, dtype = tree
        return torch.zeros(shape, dtype=dtype, device=dev)

    return make(init_cache_shapes(cfg, batch, max_len))


def head_matrix(cfg, params) -> np.ndarray:
    """The output-head weight W (padded_vocab, d_model) as float64.

    ``logits = hidden @ W.T`` — exactly the paper's A·x task per request,
    with L = padded_vocab useful rows."""
    W = params["embed"]["tok"] if cfg.tie_embeddings \
        else params["embed"]["out"].T
    return W.detach().to(torch.float64).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain-torch path)")
    ap.add_argument("--coded", action="store_true",
                    help="serve through the coded-computation bridge "
                         "(stream-planned shards)")
    ap.add_argument("--policy", default="edf",
                    choices=("fifo", "edf", "fair"),
                    help="admission policy for --coded serving")
    ap.add_argument("--coding-scope", default="head",
                    choices=("head", "ffn", "trunk"),
                    help="which matmuls run coded: the output head, plus "
                         "the FFN projections (ffn), or every trunk "
                         "projection too (trunk) (--coded serving)")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="decode tokens generated per coded admission "
                         "(--coded serving)")
    ap.add_argument("--execution", default="batched",
                    choices=("serial", "batched"),
                    help="shard-execution engine: packed per-stage passes "
                         "(batched) or the shard-by-shard reference "
                         "(serial) (--coded serving)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record per-step spans and write a "
                         "Chrome/Perfetto trace here (--coded serving)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="arm the chaos layer, e.g. 'corrupt=0.25,"
                         "kind=sign_flip,crash=0.05,retries=4,seed=5' "
                         "(--coded serving)")
    ap.add_argument("--ls-tail", action="store_true",
                    help="route every coded decode through the "
                         "stacked-LS tail (--coded serving)")
    args = ap.parse_args(argv)

    if args.coded:
        from ..serve_coded import run_coded_smoke
        return run_coded_smoke(arch=args.arch, smoke=args.smoke,
                               policies=(args.policy,),
                               n_requests=args.requests,
                               prompt_len=args.prompt_len,
                               gen_len=args.gen_len, seed=args.seed,
                               coding_scope=args.coding_scope,
                               steps_per_dispatch=args.steps_per_dispatch,
                               execution=args.execution,
                               trace=args.trace, faults=args.faults,
                               ls_tail=args.ls_tail, device=args.device)

    cfg, params = build_model(args.arch, smoke=args.smoke, seed=args.seed,
                              device=args.device)
    dev = params["final_norm"].device
    B, P, G = args.requests, args.prompt_len, args.gen_len
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(B, P))).to(dev)
    gen, t_prefill, t_decode = generate(cfg, params, prompts, G)
    print(f"[serve] {B} requests, prompt {P}, generated {gen.shape[1]} toks "
          f"on {dev}")
    print(f"[serve] prefill {t_prefill*1e3:.0f}ms  decode "
          f"{t_decode*1e3:.0f}ms  ({B*(G-1)/max(t_decode,1e-9):.0f} tok/s)")
    print(f"[serve] sample continuation: {gen[0][:12].tolist()}")
    return 0


def generate(cfg, params, prompts: torch.Tensor, gen_len: int):
    """Greedy uncoded generation: one batched prefill, then ``gen_len - 1``
    decode steps.  Returns ``(tokens (B, gen_len) numpy, prefill seconds,
    decode seconds)``, each time fenced with the device.

    An encoder-decoder's prefill gets constant encoder features (0.1,
    float32), and its decode steps no encoder output, as the reference's
    launcher runs them."""
    dev = prompts.device
    B, P = prompts.shape
    batch = {"tokens": prompts}
    if cfg.enc_dec:
        batch["enc_feats"] = torch.full(
            (B, cfg.frontend_len, cfg.frontend_dim), 0.1,
            dtype=torch.float32, device=dev)
    caches = zero_caches(cfg, B, P + gen_len + 8, device=dev)
    prefill_fn, decode_fn = serving_fns(cfg)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fence()
    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, batch, caches)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    fence()
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t1 = time.perf_counter()
    for i in range(gen_len - 1):
        pos = torch.full((B,), P + i, dtype=torch.int64, device=dev)
        logits, caches = decode_fn(params, tok, pos, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    fence()
    t_decode = time.perf_counter() - t1
    return torch.cat(out, dim=1).cpu().numpy(), t_prefill, t_decode


if __name__ == "__main__":
    sys.exit(main())
