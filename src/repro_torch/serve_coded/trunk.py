"""Host-side trunk execution with pluggable (coded) matmul dispatch — the
port of ``repro.serve_coded.trunk``.

``coding_scope="head"`` serves the torch model trunk and codes only the
output-head product.  The deeper scopes re-execute the decoder trunk on the
host in float64, routing every large matmul — attention q/k/v/o
projections and FFN up/down projections — through a caller-supplied hook,
so the serving bridge can run each one as a plan-scheduled MDS-coded task
(``coding_scope="trunk"``), or just the FFN block (``"ffn"``), while the
cheap glue (RMSNorm, RoPE, softmax, residuals, cache writes) stays local,
exactly as a master would in the paper's model (the coded workload *is*
the matrix products; everything else is O(d) bookkeeping).

The float64 host pipeline is its own reference: with the hook computing
``X @ W.T`` locally the runner is the *uncoded* server, and because MDS
decode is exact, the coded runner produces bit-identically the same greedy
tokens — the invariant ``tests/test_torch_trunk.py`` enforces across
scopes and backends.  The glue is the reference's float64 numpy, operation
for operation, so on the same weights the port's trunk reproduces the
reference's hidden states bit for bit; only the weight extraction reads
the port's own (torch) parameter tree.  On ``backend="torch"`` with
``device_products`` the matmuls themselves run on the card through the
bridge's hooks.

Supported archs: decoder-only stacks of GQA attention (optionally
sliding-window) + dense FFN (swiglu/gelu/relu2) — the shape of the
llama/gemma/glm/nemotron families.  MoE, MLA, SSM/RWKV mixers and
enc-dec raise ``NotImplementedError`` (their matmul layout needs its own
sharding story; see ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..models.config import ArchConfig, LayerSpec
from ..models.layers import ffn_weight_names
from ..models.lm import _at
from .coded_linear import host64

__all__ = ["HostTrunk", "trunk_matmul_keys"]

#: the matmul hook: (key, X (rows, D)) → X @ W_key.T  (rows, L_key)
MatmulFn = Callable[[str, np.ndarray], np.ndarray]

#: the grouped hook: a *dependency stage* of matmuls sharing one right-hand
#: operand — [(key, X), ...] → {key: X @ W_key.T}.  The batched execution
#: engine packs a whole stage's shard gathers into one product; the
#: default adapter just loops the per-matmul hook.
MatmulGroupFn = Callable[[List[Tuple[str, np.ndarray]]],
                         Dict[str, np.ndarray]]

_ATTN_KEYS = ("wq", "wk", "wv", "wo")


def trunk_matmul_keys(cfg: ArchConfig, scope: str) -> List[str]:
    """Ordered keys of the per-layer matmuls coded under ``scope``
    (excluding the head, which every scope codes)."""
    if scope == "head":
        return []
    if scope not in ("ffn", "trunk"):
        raise ValueError(f"unknown coding scope {scope!r}; "
                         f"expected head | ffn | trunk")
    keys: List[str] = []
    specs = list(cfg.prefix) + list(cfg.block) * cfg.n_repeats
    for i, spec in enumerate(specs):
        if scope == "trunk":
            keys.extend(f"blk{i}.{k}" for k in _ATTN_KEYS)
        keys.extend(f"blk{i}.{k}" for k in ffn_weight_names(spec.ffn))
    return keys


def _silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


def _gelu_tanh(x: np.ndarray) -> np.ndarray:
    # the models' gelu (its tanh approximation), in float64
    c = np.sqrt(2.0 / np.pi)
    return 0.5 * x * (1.0 + np.tanh(c * (x + 0.044715 * x ** 3)))


def _rms(x: np.ndarray, gain: np.ndarray, eps: float) -> np.ndarray:
    n = x / np.sqrt(np.mean(np.square(x), axis=-1, keepdims=True) + eps)
    return n * gain


_ROPE_TABLES: Dict[Tuple[float, int], Tuple[np.ndarray, np.ndarray]] = {}


def _rope(x: np.ndarray, positions: np.ndarray, base: float) -> np.ndarray:
    """x: (R, T, H, D) even D; positions: (R, T) — mirrors attention.rope.

    cos/sin are table lookups over the integer positions (bit-identical to
    computing them per call: the angle products are the same float64
    values), so the per-token trig cost is one gather."""
    half = x.shape[-1] // 2
    key = (float(base), half)
    P = int(positions.max()) + 1
    tab = _ROPE_TABLES.get(key)
    if tab is None or tab[0].shape[0] < P:
        p = np.arange(max(P, 512), dtype=np.float64)
        freqs = base ** (-np.arange(half, dtype=np.float64) / half)
        ang = p[:, None] * freqs
        tab = (np.cos(ang), np.sin(ang))
        _ROPE_TABLES[key] = tab
    cos = tab[0][positions][:, :, None, :]
    sin = tab[1][positions][:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)


class HostTrunk:
    """Float64 host re-execution of a decoder-only trunk.

    Weight matrices are extracted once from the torch model's params into
    the (L, D) row-sharded layout ``CodedLinear`` codes (L = output
    features), keyed ``blk{i}.wq`` … ``blk{i}.w_out`` plus ``head``;
    :meth:`forward` replays prefill/decode through a matmul hook.
    """

    def __init__(self, cfg: ArchConfig, params, head_W: np.ndarray):
        if cfg.enc_dec or cfg.mla is not None or cfg.frontend is not None:
            raise NotImplementedError(
                "coding_scope ffn/trunk serves decoder-only dense-attention "
                "archs (enc-dec/MLA/frontend trunks keep scope='head')")
        self.cfg = cfg
        self.specs: List[LayerSpec] = (list(cfg.prefix)
                                       + list(cfg.block) * cfg.n_repeats)
        for spec in self.specs:
            if spec.mixer != "attn" or spec.ffn == "moe":
                raise NotImplementedError(
                    f"coding_scope ffn/trunk supports attn+dense layers; "
                    f"got mixer={spec.mixer!r} ffn={spec.ffn!r}")
        self.n_layers = len(self.specs)
        # one weight at a time to host float64: no float64 copy of the
        # model is made on the card
        f64 = host64

        self.embed = f64(params["embed"]["tok"])          # (vocab_p, d)
        self.final_norm = f64(params["final_norm"])
        self.norms: List[Tuple[np.ndarray, np.ndarray]] = []
        #: key → (L, D) weight of ``out = X @ W.T``
        self.weights: Dict[str, np.ndarray] = {"head": f64(head_W)}

        def layer_params(i: int):
            n_prefix = len(cfg.prefix)
            if i < n_prefix:
                return params["prefix"][i]
            r, j = divmod(i - n_prefix, len(cfg.block))
            return _at(params["blocks"][f"layer{j}"], r)

        Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        d = cfg.d_model
        for i, spec in enumerate(self.specs):
            p = layer_params(i)
            self.norms.append((f64(p["norm1"]), f64(p["norm2"])))
            mx = p["mixer"]
            self.weights[f"blk{i}.wq"] = f64(mx["wq"]).reshape(d, Hq * Dh).T
            self.weights[f"blk{i}.wk"] = f64(mx["wk"]).reshape(d, Hkv * Dh).T
            self.weights[f"blk{i}.wv"] = f64(mx["wv"]).reshape(d, Hkv * Dh).T
            self.weights[f"blk{i}.wo"] = f64(mx["wo"]).reshape(Hq * Dh, d).T
            for k in ffn_weight_names(spec.ffn):
                w = f64(p["ffn"][k])
                # w_in/w_gate are (d, d_ff) = W.T; w_out is (d_ff, d) = W.T
                self.weights[f"blk{i}.{k}"] = w.T

    # -- caches --------------------------------------------------------------

    def zero_caches(self, batch: int, max_len: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        shp = (self.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"k": np.zeros(shp), "v": np.zeros(shp)}

    # -- forward -------------------------------------------------------------

    def local_matmul(self, key: str, X: np.ndarray) -> np.ndarray:
        """The uncoded reference execution of matmul ``key``."""
        return np.asarray(X, dtype=np.float64) @ self.weights[key].T

    def forward(self, tokens: np.ndarray, positions: np.ndarray,
                rows: np.ndarray, caches: Dict[str, np.ndarray],
                mm: Optional[MatmulFn] = None,
                collect: Optional[list] = None,
                mm_group: Optional[MatmulGroupFn] = None) -> np.ndarray:
        """Run ``tokens`` (R, T) at absolute ``positions`` (R, T) through
        the trunk, reading/writing the KV ``caches`` at batch indices
        ``rows`` (R,), with every projection matmul routed through ``mm``
        (None → local uncoded).  Returns the final-norm hidden states
        (R, T, d) — the output head's input.

        Prefill is (R=1, T=prompt); batched decode is (R=slots, T=1);
        positions must be the contiguous continuation of what the cache
        already holds (the serving bridge's slot bookkeeping guarantees
        it).  ``collect`` (a list) receives each layer's post-residual
        hidden state, for layer-by-layer comparison against another
        execution of the same trunk.

        ``mm_group`` is the stage-granular hook: each call hands over one
        *dependency stage* — the matmuls that share a right-hand operand
        (q/k/v on the post-norm hiddens, up/gate on the FFN input; o and
        down are single-member stages).  The data dependencies of a
        decoder layer make a stage the largest batchable unit, and the
        batched engine executes each one as a single packed pass.  When
        ``mm_group`` is None the per-matmul ``mm`` hook is looped — the
        serial reference."""
        cfg = self.cfg
        if mm_group is None:
            mm_one = mm or self.local_matmul
            mm_group = lambda items: {k: mm_one(k, X) for k, X in items}
        mmg = mm_group
        tokens = np.asarray(tokens)
        positions = np.asarray(positions)
        rows = np.asarray(rows)
        R, T = tokens.shape
        Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        G = Hq // Hkv
        d = cfg.d_model
        scale = 1.0 / np.sqrt(Dh)
        x = self.embed[tokens]                            # (R, T, d)

        for i, spec in enumerate(self.specs):
            norm1, norm2 = self.norms[i]
            h = _rms(x, norm1, cfg.norm_eps)
            h2d = h.reshape(R * T, d)
            qkv = mmg([(f"blk{i}.wq", h2d), (f"blk{i}.wk", h2d),
                       (f"blk{i}.wv", h2d)])
            q = qkv[f"blk{i}.wq"].reshape(R, T, Hq, Dh)
            k = qkv[f"blk{i}.wk"].reshape(R, T, Hkv, Dh)
            v = qkv[f"blk{i}.wv"].reshape(R, T, Hkv, Dh)
            base = cfg.rope_base_local if spec.sliding_window \
                else cfg.rope_base
            q = _rope(q, positions, base)
            k = _rope(k, positions, base)
            caches["k"][i][rows[:, None], positions] = k
            caches["v"][i][rows[:, None], positions] = v
            K = caches["k"][i][rows]                      # (R, S, Hkv, Dh)
            V = caches["v"][i][rows]
            S = K.shape[1]
            # grouped-query attention without materialising the repeated
            # (R, S, Hq, Dh) K/V: head h reads kv-head h//G, so contracting
            # the (Hkv, G) split against K directly sums the same scalars
            # in the same order as the np.repeat formulation
            qg = q.reshape(R, T, Hkv, G, Dh)
            s = np.einsum("rtkgd,rskd->rkgts", qg,
                          K).reshape(R, Hq, T, S) * scale
            kp = np.arange(K.shape[1])
            valid = kp[None, None, :] <= positions[:, :, None]   # causal
            if spec.sliding_window is not None:
                valid &= kp[None, None, :] > \
                    positions[:, :, None] - spec.sliding_window
            s = np.where(valid[:, None], s, -np.inf)
            s -= s.max(axis=-1, keepdims=True)
            p = np.exp(s)
            p /= p.sum(axis=-1, keepdims=True)
            o = np.einsum("rkgts,rskd->rtkgd",
                          p.reshape(R, Hkv, G, T, S),
                          V).reshape(R, T, Hq, Dh)
            x = x + mmg([(f"blk{i}.wo", o.reshape(R * T, Hq * Dh))
                         ])[f"blk{i}.wo"].reshape(R, T, d)

            h2 = _rms(x, norm2, cfg.norm_eps).reshape(R * T, d)
            up_keys = [(f"blk{i}.w_in", h2)]
            if spec.ffn == "swiglu":
                up_keys.append((f"blk{i}.w_gate", h2))
            ups = mmg(up_keys)
            up = ups[f"blk{i}.w_in"]
            if spec.ffn == "swiglu":
                up = _silu(ups[f"blk{i}.w_gate"]) * up
            elif spec.ffn == "gelu":
                up = _gelu_tanh(up)
            elif spec.ffn == "relu2":
                up = np.square(np.maximum(up, 0.0))
            x = x + mmg([(f"blk{i}.w_out", up)
                         ])[f"blk{i}.w_out"].reshape(R, T, d)
            if collect is not None:
                collect.append(x)

        return _rms(x, self.final_norm, cfg.norm_eps)
