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
does not divide the heads, as the reference's resolve drops an axis that
does not divide; `gathered_on` replicates a sharded dimension;
`pad_front` pads a DTensor by concatenation and `cumsum` runs on its
shards (DTensor's pad and its rule for the cumsum's backward fail on
torch 2.11).
"""

from __future__ import annotations

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


def sharded_evenly(t: torch.Tensor, dim: int, n: int) -> bool:
    """Whether ``n`` groups of ``t``'s dimension ``dim`` split evenly over
    the mesh axes that shard it (always, for a plain tensor)."""
    if not is_dtensor(t):
        return True
    from torch.distributed.tensor import Shard

    dim = dim % t.dim()
    return all(not (isinstance(p, Shard) and p.dim == dim) or n % t.device_mesh.size(i) == 0
               for i, p in enumerate(t.placements))
