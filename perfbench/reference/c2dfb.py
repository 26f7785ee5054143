"""Plain C²DFB rounds: Algorithm 1 (outer loop) with its two Algorithm 2
inner loops, written from the paper (arXiv:2410.14115) in plain PyTorch.

Nothing here comes from the program under test.  A tree is a flat dict
``path -> tensor`` whose leaves carry the node axis first.  Every
update is computed in float32 from float32 copies of its operands and
then stored at the precision the configuration states for the state and
the gradients (`Precision.store`): float32 for the paper's task, bfloat16
for the LM.
The mixing is (W - I) @ X in float32.

One outer round, per node i (node-stacked here), W the mixing matrix:

    x'    = x + gamma (W - I) x - eta_out s_x
    IN(y) : K steps on h = f + lam g at x', from y's persistent state
    IN(z) : K steps on g at x', from z's persistent state
    u'    = df/dx(x', y') + lam (dg/dx(x', y') - dg/dx(x', z'))
    s_x'  = s_x + gamma (W - I) s_x + u' - u

and an inner step (d, d_hat, s, s_hat, g_prev), Q the compressor:

    d'     = d + gamma_in (W - I) d_hat - eta s
    d_hat' = d_hat + Q(d' - d_hat)
    s'     = s + gamma_in (W - I) s_hat + grad(d') - g_prev
    s_hat' = s_hat + Q(s' - s_hat),   g_prev' = grad(d')

Before the K steps each loop re-bases its tracker on the new x:
s += grad(d) - g_prev, g_prev = grad(d).  The y loop's step is
eta_in / (1 + lam).  The compressors:

* block top-k: each node's flat leaf cut into blocks of ``block`` (the
  last zero-padded); in each block the threshold is the largest that
  keeps at least k = round(ratio * block) magnitudes, found by 24 rounds
  of bisection on [0, max |x|] in the message's own dtype; every entry at
  or above it is kept;
* stochastic quantization to ``bits`` bits, one scale (the block's largest
  magnitude) a block: x / scale on 2^bits - 1 levels of [-1, 1], rounded
  up where the block's sample u lies below the fraction.

The round's wire bytes count each node's messages once: a sparse message
9 + 8 a nonzero, a quantized one 10 + 4 a block + its packed codes, and
the outer x and s_x dense (4 bytes an entry of each node's copy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BISECT_ROUNDS = 24
SPARSE_HEADER = 9
QUANT_HEADER = 10


# ---------------------------------------------------------------- precision


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference stores its state and feeds its products.

    ``storage``: "float32", "bfloat16", or "float8" (the e4m3 format with
    one power-of-two scale a tensor, as fp8 training keeps a tensor).
    ``products``: "float32" (TF32 off), "tf32", or "float8" (each operand
    of a model product rounded as ``storage`` float8 rounds)."""

    storage: str = "float32"
    products: str = "float32"

    def store(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.float32)
        if self.storage == "float32":
            return t
        if self.storage == "bfloat16":
            return t.to(torch.bfloat16)
        if self.storage == "float8":
            return fp8_round(t)
        raise ValueError(f"unknown storage precision {self.storage!r}")

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A model product's operand: itself, or rounded to float8 with the
        gradient passed straight through."""
        if self.products != "float8":
            return t
        with torch.no_grad():
            q = fp8_round(t).to(t.dtype)
        return t + (q - t).detach()


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one power-of-two scale a tensor (its
    largest magnitude at most 448, the format's largest), held in
    bfloat16, which holds every such value exactly."""
    t = t.to(torch.float32)
    scale = torch.exp2(torch.ceil(torch.log2(torch.clamp_min(t.abs().amax(), 1e-30) / 448.0)))
    return ((t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale).to(torch.bfloat16)


class products:
    """Context: float32 products with TF32 off (or on, for ``tf32``)."""

    def __init__(self, precision: Precision):
        self.tf32 = precision.products == "tf32"

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


# ---------------------------------------------------------------- graphs


def metropolis(m: int, edges) -> np.ndarray:
    """Metropolis–Hastings weights: w_ij = 1 / (1 + max(deg_i, deg_j)) on
    an edge, the rest of each row on the diagonal."""
    deg = np.zeros(m, dtype=np.int64)
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    W = np.zeros((m, m))
    for i, j in edges:
        W[i, j] = W[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    W[np.diag_indices(m)] = 1.0 - W.sum(axis=1)
    return W


def graph_weights(name: str, m: int) -> np.ndarray:
    if name == "ring":
        return metropolis(m, [(i, (i + 1) % m) for i in range(m)])
    raise ValueError(f"no plain mixing matrix for topology {name!r}")


# ---------------------------------------------------------------- compressors


def _tiles(flat: torch.Tensor, block: int) -> torch.Tensor:
    m, d = flat.shape
    nb = -(-d // block)
    return torch.nn.functional.pad(flat, (0, nb * block - d)).reshape(m * nb, block)


def block_topk(x: torch.Tensor, ratio: float, block: int) -> torch.Tensor:
    """Per-block threshold top-k of every node's flat leaf (node axis
    first), in x's dtype."""
    m = x.shape[0]
    flat = x.reshape(m, -1)
    d = flat.shape[1]
    t = _tiles(flat, block)
    k = max(1, int(round(ratio * block)))
    ax = t.abs()
    hi = ax.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ROUNDS):
        mid = (lo + hi) * 0.5
        enough = (ax >= mid).sum(dim=1, keepdim=True) >= k
        lo = torch.where(enough, mid, lo)
        hi = torch.where(enough, hi, mid)
    kept = torch.where(ax >= lo, t, torch.zeros_like(t))
    return kept.reshape(m, -1)[:, :d].reshape(x.shape)


def quantize(x: torch.Tensor, u: torch.Tensor, bits: int, block: int) -> torch.Tensor:
    """Stochastic quantization of every node's flat leaf, one scale a block,
    in float32; ``u`` holds one sample an entry of the padded blocks."""
    m = x.shape[0]
    flat = x.reshape(m, -1).to(torch.float32)
    d = flat.shape[1]
    t = _tiles(flat, block)
    levels = float((1 << bits) - 1)
    scale = torch.clamp_min(t.abs().amax(dim=1, keepdim=True), 1e-12)
    steps = (t / scale + 1.0) * 0.5 * levels
    low = torch.floor(steps)
    q = low + (u.to(torch.float32) < steps - low).to(torch.float32)
    out = ((q / levels) * 2.0 - 1.0) * scale
    return out.reshape(m, -1)[:, :d].reshape(x.shape)


@dataclasses.dataclass
class Compressor:
    """The workload's compressor: ``kind`` "topk" or "quant".  A quantizer
    draws its samples from ``generator`` in the leaf's dtype, one draw of
    (m * blocks, block) a leaf, leaves in path order within a message."""

    kind: str
    ratio: float = 0.2
    bits: int = 4
    block: int = 1024
    generator: torch.Generator | None = None

    def __call__(self, leaf: torch.Tensor) -> torch.Tensor:
        if self.kind == "topk":
            return block_topk(leaf, self.ratio, self.block)
        m = leaf.shape[0]
        nb = -(-(leaf.numel() // m) // self.block)
        u = torch.rand((m * nb, self.block), dtype=leaf.dtype, generator=self.generator,
                       device=self.generator.device).to(leaf.device)
        return quantize(leaf, u, self.bits, self.block)

    def message_bytes(self, q: torch.Tensor) -> int:
        m = q.shape[0]
        d = q.numel() // m
        if self.kind == "topk":
            return m * SPARSE_HEADER + 8 * int(torch.count_nonzero(q))
        nb = -(-d // self.block)
        return m * (QUANT_HEADER + 4 * nb + -(-d * self.bits // 8))


# ---------------------------------------------------------------- rounds


@dataclasses.dataclass
class Inner:
    d: dict
    d_hat: dict
    s: dict
    s_hat: dict
    g_prev: dict


@dataclasses.dataclass
class State:
    x: dict
    s_x: dict
    u_prev: dict
    y: Inner
    z: Inner

    def trees(self) -> dict:
        """Every leaf of the state, by ``<tree>/<path>``."""
        out = {}
        for name, tree in (("x", self.x), ("s_x", self.s_x), ("u_prev", self.u_prev)):
            out.update({f"{name}/{k}": v for k, v in tree.items()})
        for loop in ("y", "z"):
            inner = getattr(self, loop)
            for f in dataclasses.fields(Inner):
                out.update({f"{loop}.{f.name}/{k}": v for k, v in getattr(inner, f.name).items()})
        return out


@dataclasses.dataclass(frozen=True)
class Settings:
    lam: float
    eta_out: float
    gamma_out: float
    eta_in: float
    gamma_in: float
    K: int


def _mix(Wm: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    m = v.shape[0]
    return (Wm @ v.reshape(m, -1).to(torch.float32)).reshape(v.shape)


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32)


class Round:
    """Plain C²DFB rounds on a problem's oracles.

    ``oracles`` gives gradients of node-stacked trees, computed in float32
    and stored at the state's precision:
    ``grad_y_h(x, y, lam)``, ``grad_y_g(x, z)``, ``grad_x_f(x, y)`` and
    ``grad_x_g(x, y)``, and may keep work that depends on x alone between
    ``begin_round(x)`` calls."""

    def __init__(self, oracles, W: np.ndarray, settings: Settings, compressor: Compressor, precision: Precision,
                 device):
        self.oracles = oracles
        self.Wm = torch.as_tensor(W - np.eye(W.shape[0]), dtype=torch.float32, device=device)
        self.cfg = settings
        self.comp = compressor
        self.prec = precision

    def store_tree(self, tree: dict) -> dict:
        return {k: self.prec.store(v) for k, v in tree.items()}

    def init(self, x0: dict, y0: dict) -> State:
        """Algorithm 1's start: z0 = y0, references at the models, trackers
        at the local gradients, s_x = u_prev = u0."""
        st = self.store_tree
        x0, y0 = st(x0), st(y0)
        self.oracles.begin_round(x0)
        gh = st(self.oracles.grad_y_h(x0, y0, self.cfg.lam))
        gg = st(self.oracles.grad_y_g(x0, y0))
        u0 = st(self._hyper(x0, y0, y0))
        return State(x=x0, s_x=u0, u_prev=u0, y=Inner(y0, y0, gh, gh, gh), z=Inner(y0, y0, gg, gg, gg))

    def _hyper(self, x, y, z) -> dict:
        """u from the three x-partials, each an oracle's answer stored at
        the state's precision, as every gradient here is."""
        gf, gy, gz = self.oracles.grad_x_f(x, y), self.oracles.grad_x_g(x, y), self.oracles.grad_x_g(x, z)
        return {k: _f32(gf[k]) + self.cfg.lam * (_f32(gy[k]) - _f32(gz[k])) for k in x}

    def _inner(self, st: Inner, grad, eta: float) -> tuple[Inner, int]:
        c, store = self.cfg, self.prec.store
        g = {k: store(v) for k, v in grad(st.d).items()}
        st = Inner(st.d, st.d_hat, {k: store(_f32(st.s[k]) + _f32(g[k]) - _f32(st.g_prev[k])) for k in st.s},
                   st.s_hat, g)
        nbytes = 0
        for _ in range(c.K):
            d = {k: store(_f32(st.d[k]) + c.gamma_in * _mix(self.Wm, st.d_hat[k]) - eta * _f32(st.s[k]))
                 for k in st.d}
            q_d = {k: self.comp(store(_f32(d[k]) - _f32(st.d_hat[k]))) for k in sorted(d)}
            d_hat = {k: store(_f32(st.d_hat[k]) + _f32(q_d[k])) for k in d}
            g = {k: store(v) for k, v in grad(d).items()}
            s = {k: store(_f32(st.s[k]) + c.gamma_in * _mix(self.Wm, st.s_hat[k]) + _f32(g[k]) - _f32(st.g_prev[k]))
                 for k in d}
            q_s = {k: self.comp(store(_f32(s[k]) - _f32(st.s_hat[k]))) for k in sorted(s)}
            s_hat = {k: store(_f32(st.s_hat[k]) + _f32(q_s[k])) for k in d}
            nbytes += sum(self.comp.message_bytes(v) for v in q_d.values())
            nbytes += sum(self.comp.message_bytes(v) for v in q_s.values())
            st = Inner(d, d_hat, s, s_hat, g)
        return st, nbytes

    def step(self, state: State) -> tuple[State, dict]:
        c, store, o = self.cfg, self.prec.store, self.oracles
        x = {k: store(_f32(v) + c.gamma_out * _mix(self.Wm, v) - c.eta_out * _f32(state.s_x[k]))
             for k, v in state.x.items()}
        o.begin_round(x)
        y, by = self._inner(state.y, lambda d: o.grad_y_h(x, d, c.lam), c.eta_in / (1.0 + c.lam))
        z, bz = self._inner(state.z, lambda d: o.grad_y_g(x, d), c.eta_in)
        u = {k: store(v) for k, v in self._hyper(x, y.d, z.d).items()}
        s_x = {k: store(_f32(v) + c.gamma_out * _mix(self.Wm, v) + _f32(u[k]) - _f32(state.u_prev[k]))
               for k, v in state.s_x.items()}
        m = next(iter(x.values())).shape[0]
        dx = sum(v.numel() // m for v in x.values())
        mean_u = torch.sqrt(sum(torch.sum(_f32(v).mean(dim=0) ** 2) for v in u.values()))
        metrics = {"hypergrad_norm": float(mean_u), "measured_bytes": by + bz + 2 * dx * 4 * m}
        return State(x, s_x, u, y, z), metrics


def norm(t: torch.Tensor) -> float:
    """A leaf's norm over all its nodes, summed in float32 by the device's
    reduction tree."""
    return float(torch.linalg.vector_norm(_f32(t)))


def leaf_norms(trees: dict) -> dict:
    return {k: norm(v) for k, v in trees.items()}


def change_norms(before: dict, after: dict) -> dict:
    return {k: norm(_f32(after[k]) - _f32(before[k])) for k in after}
