"""Megatron tensor parallelism for the decoder families: what each rank
keeps of a parameter tree, and the collectives its forward runs.

The JAX package places the whole tree on a mesh by PartitionSpecs and
lets XLA insert the collectives. Here each rank keeps its own slices as
plain tensors, which the port's kernels take as they are, and the
collectives are explicit:

- q/k/v, gate/up (and GPT-NeoX's fc_in) are cut along their output
  dimension N, by whole heads: a fused ``qkv_proj`` is cut per segment
  (this rank's q heads, then its K/V heads) and re-fused, a fused
  ``gate_up_proj`` per half. Where the mesh axis is wider than the K/V
  heads, each K/V head is kept by ``W / Hkv`` ranks.
- o_proj and down_proj (fc_out) are cut along their input dimension K;
  their partial products are summed over the group (two all-reduces a
  layer), in f32 when the group has more than one rank, and a bias is
  added once, after the sum. The q4_0 planes are k-major (packed
  (K/2, N), scales (K/32, N)), so a K cut must fall on a group of 32.
- The embedding rows and the head's columns are cut over the
  vocabulary: a lookup takes the rows this rank holds and sums over the
  group, and the logits are gathered. A vocabulary the axis does not
  divide stays whole on every rank.
- Norms and the MoE router are whole on every rank; with an expert axis
  each rank keeps its experts (and their N or K slices), and the MoE
  output is summed over both groups.

The tree of a rank carries its shard in plain entries: ``params["tp"]``
(a :class:`TensorShard`), a ``"reduce"`` (a :class:`GroupSum`) in each
K-cut linear and a ``"gather"`` in the cut head, and ``"e0"``, the
first expert kept, in each expert-stacked linear. Its config is a
:class:`RankConfig`: this rank's heads and widths.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from bigdl_tpu_torch.llm.ggml.quantize import QK
from bigdl_tpu_torch.parallel.mesh import mesh_axis_size


class RankConfig:
    """A rank's view of a model config: the base config's fields, with
    this rank's head counts and widths over them (``head_dim`` stays the
    model's)."""

    def __init__(self, base, **over):
        self.base = base
        self._over = dict(over, head_dim=base.head_dim)

    def __getattr__(self, name):
        over = self.__dict__.get("_over", {})
        if name in over:
            return over[name]
        return getattr(self.__dict__["base"], name)

    def __repr__(self):
        return f"RankConfig({self.base!r}, {self._over!r})"


def _axis(mesh, name: Optional[str]):
    """(size, coordinate, group) of this rank on mesh axis ``name``; an
    axis the mesh lacks is (1, 0, None)."""
    if not name or name not in (mesh.mesh_dim_names or ()):
        return 1, 0, None
    return (mesh_axis_size(mesh, name), mesh.get_local_rank(name),
            mesh.get_group(name))


class GroupSum:
    """Sums a partial result over process groups, in order."""

    def __init__(self, groups: Sequence):
        self.groups = [g for g in groups if g is not None]
        self.size = math.prod(dist.get_world_size(g) for g in self.groups)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        from bigdl_tpu_torch.parallel.collectives import all_reduce
        for g in self.groups:
            y = all_reduce(y, g)
        return y


class TensorShard:
    """This rank's tensor-parallel group: ``reduce`` sums over it,
    ``gather`` joins the last dimension, ``vocab`` the (start, end) rows
    of the embedding kept here (None: whole)."""

    def __init__(self, group, vocab: Optional[Tuple[int, int]]):
        self.group, self.vocab = group, vocab
        self.reduce = GroupSum([group])

    @property
    def capturable(self) -> bool:
        """A CUDA graph may hold this group's collectives: NCCL runs on
        the stream, gloo on the host."""
        return self.group is None or dist.get_backend(self.group) == "nccl"

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        from bigdl_tpu_torch.parallel.collectives import all_gather
        if self.group is None:
            return y
        return all_gather(y, self.group, axis=y.dim() - 1)


def embed_rows(table: torch.Tensor, toks: torch.Tensor,
               tp: Optional[TensorShard]) -> torch.Tensor:
    """The embedding rows of ``toks``; with a vocabulary cut, the rows
    this rank holds (zero elsewhere) summed over the group (exact: one
    rank adds a row, the others zeros)."""
    if tp is None or tp.vocab is None:
        return table[toks]
    v0, v1 = tp.vocab
    local = toks - v0
    here = (local >= 0) & (local < v1 - v0)
    rows = table[local.clamp(0, v1 - v0 - 1)]
    return tp.reduce(torch.where(here[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device)))


def _index(ranges: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    return torch.cat([torch.arange(a, b, device=device) for a, b in ranges])


def cut_n(wd: Dict[str, Any], ranges: List[Tuple[int, int]],
          expert: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """A linear's output columns ``ranges`` (concatenated): dense ``w``
    (..., N, K) on dim -2, k-major ``q`` / ``scale`` (..., ·, N) and the
    bias (..., N) on the last dim; ``expert`` (start, end) also keeps
    those experts of an expert-stacked (L, E, N, K) ``w``."""
    out = {}
    for k, v in wd.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        idx = _index(ranges, v.device)
        if k == "w":
            v = v.index_select(v.dim() - 2, idx)
        else:
            v = v.index_select(v.dim() - 1, idx)
        out[k] = _experts(k, v, expert)
    return out


def cut_k(wd: Dict[str, Any], k0: int, k1: int, reduce: GroupSum,
          expert: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """A linear's input rows [k0, k1): dense ``w`` (..., N, K) on the
    last dim, ``q`` (..., K/2, N) and ``scale`` (..., K/32, N) on dim -2
    (the cut must fall on a q4_0 group); the bias stays whole (added
    once, after ``reduce``)."""
    out = {"reduce": reduce}
    for k, v in wd.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        if k == "w":
            v = v[..., k0:k1]
        elif k in ("q", "scale"):
            if k0 % QK or k1 % QK:
                raise ValueError(
                    f"a K cut at [{k0}, {k1}) splits a q4_0 group of {QK} "
                    "rows: the k-major planes cut only on whole groups")
            per = 2 if k == "q" else QK
            v = v[..., k0 // per:k1 // per, :]
        out[k] = _experts(k, v, expert)
    return out


def _experts(key, v, expert):
    if expert is None or key != "w" or v.dim() != 4:
        return v.contiguous()
    return v[:, expert[0]:expert[1]].contiguous()


def vocab_cut(tp_size: int, tp_rank: int, vocab: int):
    """(start, end) of the vocabulary rows this rank keeps, or None when
    the axis does not divide the vocabulary (kept whole)."""
    if tp_size == 1 or vocab % tp_size:
        return None
    per = vocab // tp_size
    return tp_rank * per, (tp_rank + 1) * per


def head_cut(hq: int, hkv: int, w: int, r: int):
    """(first q head, q heads, first K/V head, K/V heads) of rank ``r``
    of ``w``: whole heads each, a K/V head kept by ``w / hkv`` ranks
    where ``w`` exceeds the K/V heads."""
    if hq % w:
        raise ValueError(f"{hq} attention heads do not split over {w} "
                         "ranks")
    nq = hq // w
    if hkv % w == 0:
        nkv, kv0 = hkv // w, r * (hkv // w)
    elif w % hkv == 0:
        nkv, kv0 = 1, r // (w // hkv)
    else:
        raise ValueError(f"{hkv} K/V heads neither split over nor "
                         f"replicate across {w} ranks")
    return r * nq, nq, kv0, nkv


def cut_head(head: Dict[str, Any], vocab, tp: TensorShard):
    """The head's vocabulary columns: dense ``w`` (V, H) rows, k-major
    planes (·, V) last dim; the logits are gathered (``"gather"``)."""
    if vocab is None:
        return head
    out = cut_n(head, [vocab])
    out["gather"] = tp
    return out
