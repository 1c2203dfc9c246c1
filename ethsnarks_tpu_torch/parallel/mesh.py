"""1-D device meshes (counterpart of ``ethsnarks_tpu/parallel/mesh.py``)."""

import contextlib

import torch

from .. import resolve_device


class Mesh(object):
    """An ordered tuple of devices, one a shard; hashable, so sharded
    objects can be cached per mesh."""

    def __init__(self, devices):
        self.devices = tuple(devices)

    def distinct(self):
        """The devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def synchronize(self):
        for dev in self.distinct():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def __len__(self):
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return "Mesh(%s)" % ", ".join(str(d) for d in self.devices)


def normalise(device):
    """A device as a mesh holds it: a card with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("mesh device %s: only cuda and cpu" % dev)
    return dev


def make_mesh(n_devices=None, devices=None):
    """A 1-D mesh over the first ``n_devices`` CUDA cards (default: all of
    them; raises without a card or when fewer are present), or over an
    explicit ``devices`` list, which may repeat a device (``['cuda:0'] *
    4``: four virtual shards on one card; ``['cpu'] * 4`` on the CPU).  The
    shard count must be a power of two (the NTT pairs shard d with
    d XOR 2^j), and a mesh takes cards or the CPU, never both."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=['cpu'] * n to "
                "shard on the CPU")
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if n > have:
            raise ValueError("make_mesh: %d devices asked, %d present"
                             % (n, have))
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [normalise(d) for d in devices]
        if n_devices is not None and int(n_devices) != len(devices):
            raise ValueError("make_mesh: n_devices=%d with %d devices"
                             % (n_devices, len(devices)))
    n = len(devices)
    if n < 1 or n & (n - 1):
        raise ValueError("make_mesh: %d shards is not a power of two" % n)
    if len({d.type for d in devices}) > 1:
        raise ValueError("make_mesh: a mesh of both cards and the CPU: %s"
                         % [str(d) for d in devices])
    return Mesh(devices)


def on(device):
    """Context that makes ``device`` CUDA's current device (the kernels
    launch on the current device's streams); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
