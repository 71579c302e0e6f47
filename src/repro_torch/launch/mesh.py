"""The data group of the port's data-parallel training: the counterpart of
the reference's ``repro/launch/mesh.py``, whose mesh axis "data" becomes a
``torch.distributed`` process group here.

``data_axis_size(group)`` is the group's width (the reference's
``mesh.shape["data"]``); ``init_data_group`` makes the default group from
what ``torchrun`` sets in the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) or from a rendezvous the caller names
(``init_method``, for example ``file:///path/to/store``, with ``rank`` and
``world_size``).  Nothing here runs as a single process in silence: the
data-parallel entry points take a group and raise without an initialised
one (``require_group``).

The backend is NCCL for CUDA ranks each on a card of its own; "gloo" for
CPU ranks, and for two ranks that share one card (NCCL refuses two ranks
on one device; gloo reduces CUDA tensors through host memory).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def require_group(group=None):
    """``group`` (None: the default group), checked to be initialised;
    raises ``RuntimeError`` where ``torch.distributed`` has no process
    group."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "data-parallel training needs an initialised torch.distributed "
            "process group (launch.mesh.init_data_group, or torchrun); none "
            "is initialised")
    return dist.group.WORLD if group is None else group


def data_axis_size(group=None) -> int:
    """The width of the data group: its number of ranks."""
    return dist.get_world_size(require_group(group))


def data_rank(group=None) -> int:
    """This process's rank in the data group."""
    return dist.get_rank(require_group(group))


def launched_by_torchrun() -> bool:
    """True where ``torchrun`` (or a launcher like it) set the
    environment a ``env://`` rendezvous reads."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def init_data_group(*, backend: str | None = None,
                    init_method: str | None = None, rank: int | None = None,
                    world_size: int | None = None,
                    timeout_s: float = 300.0):
    """Initialise the default process group and return it.

    Without ``init_method`` the rendezvous is ``torchrun``'s environment
    (``env://``; raises where it is missing).  With one (``file://...`` or
    ``tcp://localhost:<port>``) ``rank`` and ``world_size`` must be given.
    ``backend`` None takes "nccl" where CUDA is present and each rank has
    a card of its own (``torch.cuda.device_count() >= world_size``), else
    "gloo".  ``timeout_s`` bounds every collective: a rank that hangs
    fails its peers instead of blocking them for ever."""
    if init_method is None:
        if not launched_by_torchrun():
            raise RuntimeError(
                "init_data_group: no init_method and no torchrun environment "
                f"({', '.join(TORCHRUN_VARS)})")
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    elif rank is None or world_size is None:
        raise ValueError("init_data_group: init_method needs rank and "
                         "world_size")
    if backend is None:
        backend = "nccl" if (torch.cuda.is_available() and
                             torch.cuda.device_count() >= world_size) \
            else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def local_device(device=None) -> torch.device:
    """The device this rank trains on: ``device`` if given; else under
    ``torchrun`` ``cuda:LOCAL_RANK``, or ``cuda`` (the port's default
    device, which raises without a GPU).  A CUDA device with an index
    becomes the current one, which NCCL's object collectives and barriers
    use."""
    from repro_torch.backend import resolve_device
    if device is None and "LOCAL_RANK" in os.environ \
            and torch.cuda.is_available():
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device
