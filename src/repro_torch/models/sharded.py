"""The model's products and head splits on DTensors (the dry run's sharded
step, `repro_torch.launch.dryrun`); on plain tensors each function is the
plain operator, so a single device computes what it computed before.

DTensor folds the batch dimensions of a product into one (``aten.bmm``);
where two of them are sharded over different mesh axes (the batch over
"data", the heads over "model") the folded dimension is sharded twice and
its sharding propagation fails, and a product's backward can meet the
same fold.  `einsum`, `matmul` and `bmm` therefore run a product on each
device's shards (``local_map``, `local_product`), its gradients too: each
mesh axis shards one letter of the product, chosen from the operands'
placements (a letter of the output first, the largest operand's first,
so a weight is gathered for a batch-sharded activation and a KV cache
stays where it is), and the output is sharded on that letter, or a
Partial sum where it is contracted.  `split_dim` splits a sharded
dimension (heads, head_dim) after replicating it over a mesh axis that
does not divide the heads (a decode step's query: the attention of train
and prefill splits its heads on each device's shards instead,
`repro_torch.models.attention`); `gathered_on` replicates a sharded
dimension; `batch_positions` gives positions sharded as the batch;
`pad_front` pads a DTensor by concatenation and `cumsum` runs on its
shards (DTensor's pad and its rule for the cumsum's backward fail on
torch 2.11).

The vocabulary stays sharded where the reference's ``vocab`` axis puts
it: `vocab_parallel_nll` (the cross-entropy of logits sharded on the
vocabulary) and `vocab_parallel_embedding` (the lookup in a table sharded
on it) run on each device's shards and reduce across the shards with
explicit collectives (`sum_across`, whose gradient is the identity, so
no masked partial gradient ever meets DTensor's propagation).

Where DTensor's own rules would gather a sharded dimension, these run on
the shards with explicit collectives too: `softmax` (over a decode
cache's slots), `rms_norm_on_shards` (a norm over a sharded last
dimension) and `sum_before` (a cumulative sum's offset across the data
shards, the MoE dispatch's global positions).  `idle_model_head` lays out
an LM head whose vocabulary the model axis does not divide.
"""

from __future__ import annotations

import math

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *operands)`` (one letter a dimension, no
    ellipsis); on DTensors, on each device's shards."""
    if not any(is_dtensor(o) for o in operands):
        return torch.einsum(eq, *operands)
    ins, out = eq.replace(" ", "").split("->")
    return local_product(lambda *t: torch.einsum(eq, *t), ins.split(","), out, operands)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` of two tensors of one rank (batch dimensions,
    then the matrices); on DTensors, on each device's shards."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.matmul(a, b)
    batch = "abcdefgh"[:a.dim() - 2]
    return local_product(torch.matmul, [batch + "ij", batch + "jk"], batch + "ik", (a, b))


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)``; on DTensors, on each device's shards."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.bmm(a, b)
    return local_product(torch.bmm, ["nij", "njk"], "nik", (a, b))


def local_product(fn, ins: list, out: str, operands) -> torch.Tensor:
    """``fn(*operands)``, a product whose dimensions carry the letters
    ``ins`` (one string an operand) and ``out``, run on each device's
    shards by ``local_map``: per mesh axis, the letter the operands shard
    there that the output keeps (else a contracted one), the largest
    operand's first; the operands are brought to it (replicated where they
    lack it), the output is sharded on it or a Partial sum, and an operand
    replicated against a sharded output gets a Partial gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(o.device_mesh for o in operands if is_dtensor(o))
    ops = [o if is_dtensor(o) else DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim, run_check=False)
           for o in operands]
    by_size = sorted(zip(ops, ins), key=lambda ol: -ol[0].numel())
    in_pl, grad_pl, out_pl = [[] for _ in ops], [[] for _ in ops], []
    for i in range(mesh.ndim):
        sharded = [letters[o.placements[i].dim] for o, letters in by_size if isinstance(o.placements[i], Shard)]
        kept = [c for c in sharded if c in out]
        letter = kept[0] if kept else sharded[0] if sharded else None
        for pl, gl, letters in zip(in_pl, grad_pl, ins):
            own = letter is not None and letter in letters
            pl.append(Shard(letters.index(letter)) if own else Replicate())
            gl.append(Shard(letters.index(letter)) if own else Partial() if letter and letter in out else Replicate())
        out_pl.append(Replicate() if letter is None else Shard(out.index(letter)) if letter in out else Partial())
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*ops)


def split_dim(t: torch.Tensor, dim: int, *sizes: int) -> torch.Tensor:
    """``t`` with dimension ``dim`` split into ``sizes`` (heads, head_dim).
    A DTensor sharded on ``dim`` over a mesh axis that does not divide
    ``sizes[0]`` (4 KV heads on a model axis of 16) is first replicated
    over that axis."""
    dim = dim % t.dim()
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        want = [Replicate() if isinstance(p, Shard) and p.dim == dim and sizes[0] % t.device_mesh.size(i) else p
                for i, p in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(t.device_mesh, want)
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(t, dim)``; a DTensor's on each device's shards (the
    dimension replicated first), so its backward's ``flip`` runs on plain
    shards too (DTensor has no rule for ``flip`` on some torch versions,
    2.11)."""
    if not is_dtensor(t):
        return torch.cumsum(t, dim=dim)
    from torch.distributed.tensor.experimental import local_map

    t = gathered_on(t, dim)
    pl = list(t.placements)
    return local_map(lambda x: torch.cumsum(x, dim=dim), out_placements=pl, in_placements=(pl,),
                     device_mesh=t.device_mesh)(t)


def softmax(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.softmax(t, dim)``; a DTensor sharded on ``dim`` on each
    device's shards, its max and its sum of exponentials reduced across
    them (two all-reduces of one value a row), where DTensor's rule gathers
    the dimension.  Without a gradient: a decode step's, over the cache's
    slots."""
    if not is_dtensor(t) or not shard_dims(t, dim):
        return torch.softmax(t, dim=dim)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, dims = t.device_mesh, shard_dims(t, dim)
    pl = [Replicate() if isinstance(p, Partial) else p for p in t.placements]

    def local(x):
        top = reduce_across(torch.amax(x, dim=dim, keepdim=True), "max", mesh, dims)
        e = torch.exp(x - top)
        return e / reduce_across(torch.sum(e, dim=dim, keepdim=True), "sum", mesh, dims)

    return local_map(local, out_placements=pl, in_placements=(pl,), device_mesh=mesh,
                     redistribute_inputs=True)(t)


def pad_front(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` with ``n`` zeros in front of dimension ``dim`` (``F.pad``); a
    DTensor's as a concatenation, since its pad fails to redistribute on
    some torch versions (2.11)."""
    dim = dim % t.dim()
    if not is_dtensor(t):
        return torch.nn.functional.pad(t, [0, 0] * (t.dim() - 1 - dim) + [n, 0])
    return torch.cat([torch.zeros_like(t.narrow(dim, 0, n)), t], dim=dim)


def gathered_on(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t``; a DTensor sharded on ``dim`` replicated over those mesh axes
    first."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % t.dim()
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in t.placements]
    return t if want == list(t.placements) else t.redistribute(t.device_mesh, want)


def shard_dims(t: torch.Tensor, dim: int) -> list:
    """The mesh dimensions on which the DTensor ``t`` is sharded on its
    dimension ``dim``."""
    from torch.distributed.tensor import Shard

    dim = dim % t.dim()
    return [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim]


def shard_index(mesh, dims: list) -> tuple[int, int]:
    """This device's index among the shards of a dimension sharded over the
    mesh dimensions ``dims`` (in mesh order, the first outermost), and
    their count."""
    index, count = 0, 1
    for i in dims:
        index, count = index * mesh.size(i) + mesh.get_local_rank(i), count * mesh.size(i)
    return index, count


def reduce_across(t: torch.Tensor, op: str, mesh, dims: list) -> torch.Tensor:
    """``t`` (a local shard) reduced by ``op`` ("sum", "max") across the
    devices of the mesh dimensions ``dims``, one all-reduce a dimension (of
    more than one device)."""
    import torch.distributed._functional_collectives as funcol

    for i in (i for i in dims if mesh.size(i) > 1):
        t = funcol.all_reduce(t, op, (mesh, i))
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


def sum_before(t: torch.Tensor, mesh, dims: list) -> torch.Tensor:
    """The sum of ``t`` (a local value, no gradient) over the devices that
    come before this one along the mesh dimensions ``dims`` (in
    `shard_index`'s order): one all-gather a dimension (of more than one
    device).  The offset of this device's shard in a cumulative sum over a
    dimension sharded there."""
    import torch.distributed._functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    every = t[None]
    for i in reversed([i for i in dims if mesh.size(i) > 1]):
        every = gather(every, 0, (mesh, i))
        if isinstance(every, funcol.AsyncCollectiveTensor):
            every = every.wait()
    index = shard_index(mesh, [i for i in dims if mesh.size(i) > 1])[0]
    return torch.sum(every[:index], dim=0)


class _SumAcross(torch.autograd.Function):
    """`reduce_across` by sum, whose gradient is the incoming one: the sum
    is replicated, so each device's gradient is already the whole."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        return reduce_across(t, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_across(t: torch.Tensor, mesh, dims: list) -> torch.Tensor:
    return _SumAcross.apply(t, mesh, dims) if dims else t


class _PSum(torch.autograd.Function):
    """`reduce_across` by sum where each device uses the sum in its own
    way: the gradient is the sum of the devices' gradients."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return reduce_across(t, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return reduce_across(grad, "sum", ctx.mesh, ctx.dims), None, None


def rms_norm_on_shards(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """`repro_torch.models.layers.rms_norm` of a DTensor x (m, ..., d)
    sharded on d, on each device's shards: the sum of squares all-reduced
    across d's shards (and its gradient so), where DTensor's rules gather x
    in the backward pass.  ``scale`` (m, d)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, d = x.device_mesh, x.shape[-1]
    dims = shard_dims(x, -1)
    x_pl = list(x.placements)
    s_pl = [Shard(1) if i in dims else Replicate() for i in range(mesh.ndim)]
    s_grad = [Shard(1) if i in dims else Partial() if isinstance(p, Shard) else Replicate()
              for i, p in enumerate(x_pl)]

    def local(x_, s_):
        xf = x_.to(torch.float32)
        var = _PSum.apply(torch.sum(torch.square(xf), dim=-1, keepdim=True), mesh, dims) / d
        out = xf * torch.rsqrt(var + eps)
        s_ = s_.reshape(s_.shape[0], *([1] * (x_.dim() - 2)), s_.shape[-1])
        return (out * s_.to(torch.float32)).to(x_.dtype)

    return local_map(local, out_placements=x_pl, in_placements=(x_pl, s_pl), in_grad_placements=(x_pl, s_grad),
                     device_mesh=mesh, redistribute_inputs=True)(x, scale)


class _VocabNLL(torch.autograd.Function):
    """-log softmax(logits)[label] over a vocabulary sharded across the
    devices of ``dims``: logits (..., V_local) f32 hold the vocabulary
    entries [offset, offset + V_local), labels (...) the global entries.
    The max, the sum of exponentials and the label's logit are reduced
    across the shards; the gradient, softmax - onehot, is local."""

    @staticmethod
    def forward(ctx, logits, labels, offset, mesh, dims):
        top = reduce_across(torch.amax(logits, dim=-1), "max", mesh, dims)
        total = reduce_across(torch.sum(torch.exp(logits - top[..., None]), dim=-1), "sum", mesh, dims)
        lse = torch.log(total) + top
        local = labels - offset
        inside = (local >= 0) & (local < logits.shape[-1])
        idx = torch.where(inside, local, 0)[..., None]
        picked = torch.where(inside, torch.gather(logits, -1, idx)[..., 0], 0.0)
        ctx.save_for_backward(logits, lse, idx, inside)
        return lse - reduce_across(picked, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        logits, lse, idx, inside = ctx.saved_tensors
        probs = torch.exp(logits - lse[..., None]) * grad[..., None]
        hit = torch.zeros_like(probs).scatter(-1, idx, torch.where(inside, grad, 0.0)[..., None])
        return probs - hit, None, None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's negative log-likelihood of its label, logits (...,
    V) f32 a DTensor (sharded on V where the head's vocabulary is; V
    replicated works too; a Partial sum is reduced first), labels (...) an
    integer DTensor.  On each device's shards: no (..., V) tensor is
    gathered."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    dims = shard_dims(logits, -1)
    index, count = shard_index(mesh, dims)
    offset = index * (logits.shape[-1] // count)
    pl = [Replicate() if isinstance(p, Partial) else p for p in logits.placements]
    lab_pl = [Replicate() if i in dims else p for i, p in enumerate(pl)]
    fn = lambda lg, lb: _VocabNLL.apply(lg, lb, offset, mesh, dims)  # noqa: E731
    return local_map(fn, out_placements=lab_pl, in_placements=(pl, lab_pl), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def vocab_parallel_embedding(table: torch.Tensor, tokens: torch.Tensor, lookup) -> torch.Tensor:
    """``lookup(table, tokens)`` (table (m, V, D), tokens (m, ...) ->
    (m, ..., D)) with the table and the tokens DTensors: each device looks
    up the tokens of its vocabulary shard (the rest give zeros) and the
    rows are summed across the vocabulary's shards.  Where the table's
    shard has fewer rows than the device has tokens, it is gathered over
    the mesh dimensions that shard D (FSDP) and the output has the tokens'
    placements; else (a decode step's few tokens) the tokens are gathered
    instead and looked up in the table's D shards, and the output is
    sharded on D there.  Either way the output is replicated across the
    vocabulary's shards, and the table's gradient has the table's
    placements, a Partial sum where the table was gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    dims = shard_dims(table, 1)
    index, count = shard_index(mesh, dims)
    offset = index * (table.shape[1] // count)
    local_tokens = tokens.numel() // math.prod(mesh.size(i) for i, p in enumerate(tokens.placements)
                                               if isinstance(p, Shard))
    cols = shard_dims(table, 2) if table.shape[1] // count > local_tokens else []
    tok_pl = [Replicate() if i in dims or i in cols else p for i, p in enumerate(tokens.placements)]
    tab_pl = [Shard(1) if i in dims else Shard(2) if i in cols else Replicate() for i in range(mesh.ndim)]
    grad_pl = [t if i in dims or i in cols else Partial() if isinstance(p, Shard) else Replicate()
               for i, (t, p) in enumerate(zip(tab_pl, tok_pl))]
    out_pl = [Shard(tokens.dim()) if i in cols else p for i, p in enumerate(tok_pl)]

    def local(tab, tok):
        rel = tok - offset
        inside = (rel >= 0) & (rel < tab.shape[1])
        rows = lookup(tab, torch.where(inside, rel, 0))
        return sum_across(torch.where(inside[..., None], rows, 0.0), mesh, dims)

    return local_map(local, out_placements=out_pl, in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def idle_model_dims(w: torch.Tensor) -> list:
    """The "model" mesh dimensions (of more than one device) on which the
    DTensor weight ``w`` is not sharded at all: an LM head whose vocabulary
    the model axis does not divide (mamba2-2.7b's 50,280 on 16)."""
    from torch.distributed.tensor import Shard

    mesh = w.device_mesh
    return [i for i, n in enumerate(mesh.mesh_dim_names)
            if n == "model" and mesh.size(i) > 1 and not isinstance(w.placements[i], Shard)]


class _IdleModelHead(torch.autograd.Function):
    """``bmm(x, w)`` (x (m, T, D), w (m, D, V)) whose weight gradient is
    computed on the model axis' share of d_model: the reference's compiled
    step gives the idle model axis that product (and no other), so each
    device forms x[..., its D / n]^T dy, a Partial sum over the data axes."""

    @staticmethod
    def forward(ctx, x, w, dims):
        ctx.save_for_backward(x, w)
        ctx.dims = dims
        return bmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        from torch.distributed.tensor import Shard

        x, w = ctx.saved_tensors
        split = [Shard(2) if i in ctx.dims else p for i, p in enumerate(x.placements)]
        dw = einsum("ntd,ntv->ndv", x.redistribute(x.device_mesh, split), dy)
        return bmm(dy, w.transpose(1, 2)), dw, None


def idle_model_head(x: torch.Tensor, w: torch.Tensor, serve: bool) -> torch.Tensor:
    """The LM head's product x (m, T, D) @ w (m, D, V) on DTensors where the
    model axis leaves the vocabulary whole (`idle_model_dims`), laid out as
    the reference's compiled steps lay it out.  A train step (``serve``
    false): the product as `bmm` (w gathered over the data axes), its
    weight gradient on the model axis' share of d_model
    (`_IdleModelHead`).  A serve step's few tokens: split on d_model as w's
    rows are, over the data axes (w does not move), and, where the tokens
    were sharded over them (gathered now), within them over the model axis
    too; the logits, Partial sums, are then brought to x's batch
    sharding."""
    from torch.distributed.tensor import Replicate, Shard

    dims = idle_model_dims(w)
    if not serve:
        return _IdleModelHead.apply(x, w, dims)
    mesh = w.device_mesh
    tokens = any(isinstance(p, Shard) and p.dim == 1 for p in x.placements)
    split = [Shard(2) if isinstance(p, Shard) and p.dim == 1 or (tokens and i in dims) else Replicate()
             for i, p in enumerate(w.placements)]
    out = einsum("ntd,ndv->ntv", x.redistribute(mesh, split),
                 w.redistribute(mesh, [Shard(1) if isinstance(p, Shard) else p for p in split]))
    return out.redistribute(mesh, [p if isinstance(p, Shard) and p.dim == 1 else Replicate() for p in x.placements])


def batch_positions(like: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S) int32 positions, ``arange(S)`` a row, as a DTensor sharded as
    the DTensor ``like`` (m, B, ...) shards its batch (dimension 1), so a
    mask built from them has each device's batch rows only."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = like.device_mesh
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == 1 else Replicate() for p in like.placements]
    B = like.shape[1]
    local_b = B // math.prod(mesh.size(i) for i, p in enumerate(pl) if isinstance(p, Shard))
    local = torch.arange(S, dtype=torch.int32, device=like.to_local().device).expand(local_b, S).contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False)
