"""Host-level collectives of the launch layer
(multimodal_sae_tpu/parallel/collectives.py).

The reference ends every multi-rank flow in a torch.distributed collective:
a barrier before the rank-0 cache merge (reference
sae_auto_interp/features/cache.py:230, launch/cache/cache.py:79-97),
`all_gather_object` then a rank-0 save for attribution (reference
launch/features/attribution_patching.py:50-60), `gather_object` then a
rank-0 json for steering (reference launch/features/steering.py:92-106) and
`all_gather_object` for segment scores (reference
launch/score/segment.py:156-172).  These are those calls.  Each is a
passthrough at world 1.  Payloads are pickled into host tensors over a
gloo group (the default group when it is gloo, else one made beside the
NCCL group), so a multi-GB merge never stages in device memory, which is
what the JAX package's 32 MB chunking guarded against; no chunking is
needed here.

`all_to_all_rows` is the tensor exchange of module-sharded training
(reference trainer.py:513-538, `dist.all_to_all`).
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.misc import process_count, process_index

_object_groups: dict = {}  # the gloo group beside each NCCL default group


def object_group(timeout=None):
    """The group object payloads travel over: None (the default group) when
    its backend is gloo, else a gloo group of every rank, made on first use.
    Making it is collective: every rank calls this at the same point, as
    `initialize_distributed` and the first object collective do."""
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if world not in _object_groups:
        _object_groups[world] = dist.new_group(backend="gloo", **({} if timeout is None else {"timeout": timeout}))
    return _object_groups[world]


def all_gather_objects(obj: Any) -> List[Any]:
    """One picklable object from every rank, in rank order, on every rank
    (reference `dist.all_gather_object`)."""
    world = process_count()
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj, group=object_group())
    return out


def gather_objects(obj: Any, root: int = 0) -> Optional[List[Any]]:
    """One picklable object from every rank, in rank order, on `root`; None
    on the other ranks (reference `dist.gather_object`)."""
    world = process_count()
    if world == 1:
        return [obj]
    out = [None] * world if process_index() == root else None
    dist.gather_object(obj, out, dst=root, group=object_group())
    return out


def barrier(name: str) -> None:
    """Block until every rank reaches the barrier of this `name`; raise if
    another rank reached one of another name (their control flow diverged:
    pairing the two would merge before every rank's files exist)."""
    if process_count() == 1:
        return
    names = all_gather_objects(name)
    if any(other != name for other in names):
        raise RuntimeError(f"barrier {name!r} met barriers {names} (one per rank): the ranks' control flow diverged")


def all_to_all_rows(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Send `parts[j]` (rows, ...) to rank j; returns what every rank sent
    this one, in rank order.  The parts of one call share a dtype, a device
    and the shape past their rows; their row counts may differ.

    The exchange is one `all_to_all_single` over the parts' bytes (a pure
    copy, whatever the dtype), after an exchange of the row counts.  Its
    route follows the default group's backend: NCCL moves the device
    tensors; gloo has no all-to-all for CUDA tensors, so under gloo a CUDA
    part is staged through pinned host memory and the result copied back
    to the card (`staging_route` names the route).  At world 1 the part
    comes back as it is."""
    world = process_count()
    if len(parts) != world:
        raise ValueError(f"{len(parts)} parts for {world} ranks")
    if world == 1:
        return [parts[0]]
    first = parts[0]
    tail = tuple(first.shape[1:])
    if any(p.dtype != first.dtype or p.device != first.device or tuple(p.shape[1:]) != tail for p in parts):
        raise ValueError("the parts of one exchange must share a dtype, a device and the shape past their rows")
    staged = staging_route(first.device) == "host"
    wire = torch.device("cpu") if staged else first.device
    send_rows = [p.shape[0] for p in parts]
    recv_rows = torch.empty(world, dtype=torch.int64, device=wire)
    dist.all_to_all_single(recv_rows, torch.tensor(send_rows, dtype=torch.int64, device=wire))
    recv_rows = [int(n) for n in recv_rows.tolist()]
    row_bytes = first.element_size() * math.prod(tail)
    send = torch.cat([p.contiguous().view(-1).view(torch.uint8) for p in parts])
    if staged:
        send = torch.empty(send.shape, dtype=torch.uint8, pin_memory=True).copy_(send)
    recv = torch.empty(sum(recv_rows) * row_bytes, dtype=torch.uint8, device=wire, pin_memory=staged)
    dist.all_to_all_single(recv, send, output_split_sizes=[n * row_bytes for n in recv_rows],
                           input_split_sizes=[n * row_bytes for n in send_rows])
    out = recv.to(first.device) if staged else recv
    out = out.view(first.dtype).view((sum(recv_rows),) + tail)
    return list(out.split(recv_rows))


def staging_route(device: torch.device, group=None) -> str:
    """How CUDA tensors of `device` cross `group` (default: the world):
    "host" (pinned host memory) under gloo, which has no all-to-all for
    CUDA tensors, else "device"."""
    return "host" if dist.get_backend(group) == "gloo" and torch.device(device).type == "cuda" else "device"
