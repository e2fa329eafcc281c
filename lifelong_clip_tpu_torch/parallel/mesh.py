"""The (data, model) device mesh on ``torch.distributed``.

Counterpart of ``lifelong_clip_tpu/parallel/mesh.py``. JAX runs one
controller over N devices and places arrays on a ``jax.sharding.Mesh``; the
port runs one process a device (``torchrun``), each rank the same host
program: the same seeded stream, replay draws and class vocabulary (JAX's
shared seeded RNG streams). Rank ``r`` of a ``D x M`` mesh sits at
``(r // M, r % M)``, as JAX's ``np.reshape(devices, shape)``:

  * ``data``  — batch rows: every rank builds the same global batch and
                keeps rows ``[i * B/D, (i + 1) * B/D)`` of its data index
                ``i``; after the backward the trainable grads are averaged
                over the data group in one all-reduce (JAX's ``pmean``);
  * ``model`` — tensor parallelism of the frozen towers (attention heads
                and MLP hidden units split over the model group, the
                reductions written out by hand where GSPMD inserts them for
                JAX) and expert parallelism of the MoE adapters.

The collectives that gradients pass through are autograd Functions:
``copy_to_model`` (identity forward, all-reduce backward) and
``reduce_from_model`` (all-reduce forward, identity backward) bracket a
model-parallel region, ``take`` reads this rank's slice of a replicated
leaf (its backward all-reduces the zero-filled grad, so every rank ends
with the whole grad), ``gather_rows`` all-gathers along rows,
``mean_over`` is a differentiable ``pmean`` and ``ring_permute`` hands a
tensor to the next rank of the model group (``lax.ppermute`` over a ring).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's place in a ``(data, model)`` grid of ranks and its two
    groups (None for an axis of size 1: nothing to reduce)."""

    def __init__(self, shape: Tuple[int, int], rank: int,
                 device: torch.device):
        d, m = shape
        self.shape = {DATA_AXIS: d, MODEL_AXIS: m}
        self.rank = rank
        self.device = device
        self.data_rank, self.model_rank = divmod(rank, m)
        self.data_group = self.model_group = None
        # every rank creates every subgroup, in the same order
        if d > 1:
            for j in range(m):
                g = dist.new_group([i * m + j for i in range(d)])
                if j == self.model_rank:
                    self.data_group = g
        if m > 1:
            for i in range(d):
                g = dist.new_group([i * m + j for j in range(m)])
                if i == self.data_rank:
                    self.model_group = g

    @property
    def data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes the run's files."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` (``n % data == 0``)."""
        b = n // self.data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def local(self, a):
        """This rank's rows of ``a`` (array or tensor)."""
        return a[self.rows(len(a))]

    def fold_gen(self, gen: torch.Generator) -> torch.Generator:
        """This rank's generator for one step's per-row draws (JAX
        ``dp_fold_rng``): one draw from the replicated ``gen`` seeds it,
        offset by the data index, so the ranks draw different augmentation
        policies, CutMix boxes and gate noise for their different rows
        while ``gen`` itself stays the same on every rank."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        return torch.Generator().manual_seed(seed + self.data_rank)

    def all_mean(self, tensors, totals=()):
        """One all-reduce over the data group for every tensor of
        ``tensors`` (averaged) and of ``totals`` (summed), through one flat
        fp32 buffer; the results are written back in place."""
        ts = list(tensors) + list(totals)
        n = self.data
        flat = torch.cat([t.reshape(-1).float() for t in tensors]
                         + [t.reshape(-1).float() * n for t in totals])
        dist.all_reduce(flat, group=self.data_group)
        flat /= n
        off = 0
        with torch.no_grad():
            for t in ts:
                k = t.numel()
                t.copy_(flat[off:off + k].view_as(t))
                off += k

    def barrier(self):
        dist.barrier()


def local_rows(a, dp: Optional[Mesh]):
    """A step's per-sample array as the step takes it: this rank's rows
    under the data-parallel mesh ``dp`` (a view of a batch the prefetcher
    uploaded whole), all of it without."""
    if dp is None:
        return a
    return dp.local(a)


def make_mesh(shape: Tuple[int, int], device: torch.device) -> Mesh:
    """The mesh of this process group (``make_mesh``): ``shape`` is
    ``(data, model)`` and must cover the group's ranks exactly."""
    d, m = shape
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"--mesh {d}x{m} needs one process a device under torchrun "
            f"(torchrun --nproc_per_node {d * m} -m "
            f"lifelong_clip_tpu_torch.main ...): no process group")
    world = dist.get_world_size()
    if d * m != world:
        raise ValueError(f"mesh shape {(d, m)} != {world} processes")
    return Mesh((d, m), dist.get_rank(), device)


# -- the model axis -----------------------------------------------------------

_MODEL_MESH: Optional[Mesh] = None


@contextlib.contextmanager
def model_parallel(mesh: Optional[Mesh]):
    """Run the towers' blocks split over ``mesh``'s model group inside the
    block (``tensor_parallel()`` reads it); a mesh with no model axis, or
    None, leaves them whole."""
    global _MODEL_MESH
    prev = _MODEL_MESH
    _MODEL_MESH = mesh if mesh is not None and mesh.model > 1 else None
    try:
        yield
    finally:
        _MODEL_MESH = prev


def tensor_parallel() -> Optional[Mesh]:
    """The mesh whose model group the blocks split across, or None."""
    return _MODEL_MESH


def head_columns(width: int, mesh: Mesh) -> slice:
    """This rank's share of ``width`` units (heads' columns, hidden units,
    experts) split evenly over the model group."""
    k = width // mesh.model
    return slice(mesh.model_rank * k, (mesh.model_rank + 1) * k)


def qkv_columns(d: int, mesh: Mesh) -> torch.Tensor:
    """This rank's columns of a fused ``[q | k | v]`` (..., 3D) leaf: its
    heads of q, of k and of v (a contiguous split of 3D would give one rank
    all of q and half of k)."""
    s = head_columns(d, mesh)
    return torch.cat([torch.arange(p * d + s.start, p * d + s.stop)
                      for p in range(3)])


def param_split(name: str, leaf) -> Optional[int]:
    """The dim of a layer-stacked block leaf that the model axis splits
    (JAX ``param_partition_spec``), or None for a replicated leaf: the
    fused qkv (L, D, 3D) and MLP up-projection (L, D, 4D) and their biases
    by output units (heads, hidden units), the attention output (L, D, D)
    and MLP down-projection (L, 4D, D) by input units."""
    if name in ("w_qkv", "w_fc") and leaf.dim() == 3:
        return 2
    if name in ("b_qkv", "b_fc") and leaf.dim() == 2:
        return 1
    if name in ("w_out", "w_proj") and leaf.dim() == 3:
        return 1
    return None


def _path_leaves(tree, fn, path=()):
    """``fn(path, leaf)`` over a nested dict/list tree, keeping its
    structure; ``path`` holds the keys (list indices as strings)."""
    if isinstance(tree, dict):
        return {k: _path_leaves(v, fn, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_path_leaves(v, fn, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def shard_params(tree, mesh: Mesh):
    """The frozen towers with their block leaves cut to this rank's slice
    (JAX ``shard_params(..., tensor_parallel=True)``): ``[q | k | v]`` by
    this rank's heads of each, the rest by ``head_columns``. Every other
    leaf is kept whole. Raises unless the heads and hidden units divide
    the model axis."""
    def cut(name, leaf):
        dim = param_split(name, leaf)
        if dim is None:
            return leaf
        width = leaf.shape[dim]
        if name in ("w_qkv", "b_qkv"):
            width //= 3
        if width % mesh.model:
            raise ValueError(f"{name} width {width} does not split over a "
                             f"{mesh.model}-way model axis")
        index = (qkv_columns(width, mesh) if name in ("w_qkv", "b_qkv")
                 else torch.arange(width)[head_columns(width, mesh)])
        return leaf.index_select(dim, index.to(leaf.device)).contiguous()

    return _path_leaves(tree, lambda path, leaf: cut(path[-1], leaf))


def shard_params_pp(tree, mesh: Mesh, match=("vision", "blocks")):
    """Pipeline placement (JAX ``shard_params_pp``): a leaf whose path holds
    every name in ``match`` and whose leading (layer) dim divides the stage
    count (the model axis) becomes this rank's contiguous slice ``[s * L/S,
    (s + 1) * L/S)`` of its stage ``s``, a fresh leaf (trainable slices take
    their own grads); every other leaf is kept whole. ``match=()`` cuts a
    tree that is layer-stacked throughout (the vision LoRA subtree). With
    one stage the tree comes back as it is."""
    n = mesh.model
    if n == 1:
        return tree

    def place(path, leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() >= 1
                and all(m in path for m in match) and leaf.shape[0] % n == 0):
            k = leaf.shape[0] // n
            cut = leaf.detach()[mesh.model_rank * k:(mesh.model_rank + 1) * k]
            return cut.clone().requires_grad_(leaf.requires_grad)
        return leaf

    return _path_leaves(tree, place)


@torch.no_grad()
def gather_stages(tree, mesh: Mesh, n_layers: int,
                  match=("vision", "blocks")):
    """The whole tree of a staged one (``shard_params_pp``'s inverse, for
    checks against the 1-process tree): each leaf on a matching path whose
    leading dim is ``n_layers / S`` is all-gathered over the model group in
    stage order; every other leaf is returned as it is (a leaf kept whole
    whose leading dim happened to be ``n_layers / S`` would be gathered too:
    the CLIP and PEFT trees have none). Every rank of the model group must
    call it."""
    n = mesh.model
    if n == 1:
        return tree

    def join(path, leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() >= 1
                and all(m in path for m in match)
                and leaf.shape[0] * n == n_layers):
            x = leaf.detach().contiguous()
            out = x.new_empty((n_layers,) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=mesh.model_group)
            return out
        return leaf

    return _path_leaves(tree, join)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, index, group):
        ctx.shape, ctx.dim, ctx.index, ctx.group = x.shape, dim, index, group
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape).index_copy_(ctx.dim, ctx.index, g)
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.group, ctx.n, ctx.rank, ctx.b = group, n, rank, x.shape[0]
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.b:(ctx.rank + 1) * ctx.b], None, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def _roll(x, group, n, rank, shift):
    """Rank ``(rank - shift) % n``'s ``x`` of the group: one all-gather
    into one tensor (the one transport that gloo takes on CPU and CUDA
    tensors alike, and nccl too), of which this rank keeps one slice."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    src = (rank - shift) % n
    return out[src * x.shape[0]:(src + 1) * x.shape[0]].clone()


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.group, ctx.n, ctx.rank = group, n, rank
        return _roll(x, group, n, rank, 1)

    @staticmethod
    def backward(ctx, g):
        # the inverse permutation: each grad goes back to the rank before
        return _roll(g, ctx.group, ctx.n, ctx.rank, -1), None, None, None


def copy_to_model(x, mesh: Mesh):
    """``x`` entering a model-parallel region: identity forward; the
    backward sums the ranks' partial grads over the model group."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x, mesh: Mesh):
    """The ranks' partial sums of a row-parallel product, summed over the
    model group; the backward passes the (replicated) grad through."""
    return _ReduceFromModel.apply(x, mesh.model_group)


def take(x, dim: int, index, mesh: Mesh):
    """``x.index_select(dim, index)`` of a leaf replicated over the model
    group; the backward all-reduces the zero-filled whole grad, so every
    rank ends with the grad of the whole leaf."""
    if isinstance(index, slice):
        index = torch.arange(index.start, index.stop)
    return _Take.apply(x, dim, index.to(x.device), mesh.model_group)


def gather_rows(x, mesh: Mesh):
    """The data group's rows of ``x`` in rank order (an all-gather along
    dim 0); the backward sums the grads and keeps this rank's rows."""
    return _GatherRows.apply(x, mesh.data_group, mesh.data, mesh.data_rank)


def mean_over(x, mesh: Mesh):
    """``pmean`` over the data group: the mean of the ranks' values; its
    backward averages the grads the same way."""
    return _MeanOver.apply(x, mesh.data_group, mesh.data)


def ring_permute(x, mesh: Mesh):
    """``x`` sent to model rank ``(s + 1) % S`` and received from ``(s - 1)
    % S`` (JAX ``lax.ppermute`` over the ring ``[(i, (i + 1) % S)]``); the
    backward is the inverse permutation. Every rank of the model group must
    call it. The all-gather moves S times the bytes of a point-to-point
    send."""
    return _RingPermute.apply(x, mesh.model_group, mesh.model,
                              mesh.model_rank)
