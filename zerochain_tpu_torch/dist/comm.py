"""The collectives of ``dist/``: dim-0 exchanges over a torch.distributed
process group, each checked against its group's backend and counted.

JAX's ``all_to_all`` and ``all_gather`` take any axis; the exchanges here
split and join dim 0 of a contiguous tensor, so callers move the axis to
the front first.  The card's world runs NCCL (gloo has no all-to-all for
CUDA tensors), the CPU's gloo: a group whose backend does not serve the
tensors' device raises, and nothing is copied to the host to get round it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# collectives run by this process, and the bytes it put into them
# (bumped where a collective is launched, nowhere else)
stats = {"all_to_all": 0, "all_to_all_bytes": 0,
         "all_gather": 0, "all_gather_bytes": 0}

BACKEND_FOR = {"cpu": "gloo", "cuda": "nccl"}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def world(group=None) -> tuple[int, int]:
    """-> (this process's rank, the group's size); raises where no process
    group has been initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_rank(group), dist.get_world_size(group)


def check_backend(t: torch.Tensor, group=None) -> None:
    """Raise unless the group's backend is the one for t's device (gloo on
    the CPU, NCCL on the card); a group may name one a device type
    ("cpu:gloo,cuda:nccl")."""
    want = BACKEND_FOR.get(t.device.type)
    backend = str(dist.get_backend(group)).lower()
    if ":" in backend:
        got = dict(p.split(":") for p in backend.split(",")).get(t.device.type)
    else:
        got = backend
    if want is None or got != want:
        raise RuntimeError(f"{t.device.type} tensors need a {want} process "
                           f"group; this group's backend is {backend!r}")


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """t: (n, ...), part i for rank i -> (n, ...), part i from rank i."""
    check_backend(t, group)
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    stats["all_to_all"] += 1
    stats["all_to_all_bytes"] += t.numel() * t.element_size()
    return out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """t: (m, ...) -> (n, m, ...), rank i's t at i."""
    check_backend(t, group)
    _, n = world(group)
    t = t.contiguous()
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    # torch 2.13 deprecates it for all_gather_single, which 2.11 lacks
    dist.all_gather_into_tensor(out, t, group=group)
    stats["all_gather"] += 1
    stats["all_gather_bytes"] += t.numel() * t.element_size()
    return out.reshape(n, *t.shape)
