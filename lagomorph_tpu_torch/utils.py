"""Progress bars, the process group and the command-line tooling of the
port.

Port of ``lagomorph_tpu/utils.py``: :func:`process_count`,
:func:`process_index` and :func:`local_device_count`, and :class:`Tool`,
the base of the two-level command line (``python -m lagomorph_tpu_torch
<module> <command>``), with its compute arguments and the provenance stamp
of output files.  The JAX package's multi-host arguments
(``--coordinator_address``, ``--num_processes``, ``--process_id``) start a
``torch.distributed`` process group, one process per device; ``--device``
takes the place of ``--platform``, which has no meaning here.  ``tqdm`` is
optional: it is imported only when a progress bar is shown.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["Tool", "local_device_count", "process_count", "process_index", "progress",
           "torch_device"]

# seconds a collective of the process group waits before it fails (a
# process that stopped must not hang the others for ever)
PROCESS_GROUP_TIMEOUT_S = 300


def _group():
    """``torch.distributed`` when a default process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_count() -> int:
    """Number of processes in this job: the default process group's world
    size, 1 without one."""
    dist = _group()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    """This process's rank (rank 0 does IO and progress), 0 without a
    process group."""
    dist = _group()
    return dist.get_rank() if dist is not None else 0


def local_device_count() -> int:
    """Number of CUDA devices this process sees (1, the CPU, where there is
    none)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def progress(iterable, desc=None, **kwargs):
    """``iterable`` behind a ``tqdm`` progress bar, or ``iterable`` itself
    when ``tqdm`` does not import (a bar is display only)."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, **kwargs)


def torch_device(device):
    """``device`` as a torch device, the first CUDA card when None; a CUDA
    device raises where there is none (no fallback to the CPU)."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device (torch.cuda.is_available() is false); "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


class Tool:
    """Base class for two-level CLIs: ``<prog> <subcommand> [args...]``.

    Subclasses declare ``module_name`` and ``subcommands``; each subcommand
    is a method of the same name that builds its own argparse parser with
    :meth:`new_parser` and reads ``sys.argv[2:]``.  :meth:`run` looks at the
    first token and calls the matching method or prints an overview."""

    module_name = None
    subcommands = []

    def _prog(self, subcmd=None):
        base = f"python -m {self.module_name}"
        return base if subcmd is None else f"{base} {subcmd}"

    def _overview(self):
        lines = [f"usage: {self._prog()} <command> [<args>]", "", "commands:"]
        for name in self.subcommands:
            doc = self.describe_subcommand(name) or ""
            summary = next((ln.strip() for ln in doc.splitlines() if ln.strip()), "")
            lines.append(f"  {name:<14} {summary}")
        return "\n".join(lines) + "\n"

    def run(self, argv=None):
        argv = sys.argv if argv is None else argv
        cmd = argv[1] if len(argv) > 1 else None
        if cmd in ("-h", "--help", None):
            print(self._overview())
            sys.exit(0 if cmd else 1)
        if cmd not in self.subcommands:
            print(f"ERROR: unknown command {cmd!r}\n")
            print(self._overview())
            sys.exit(1)
        self.call_subcommand(cmd)

    def describe_subcommand(self, name):
        return getattr(self, name).__doc__

    def new_parser(self, subcmd=None, **kwargs):
        return argparse.ArgumentParser(
            prog=self._prog(subcmd),
            formatter_class=argparse.ArgumentDefaultsHelpFormatter,
            **kwargs,
        )

    def call_subcommand(self, name):
        getattr(self, name)()

    @staticmethod
    def _compute_args(parser):
        """Add the compute arguments: the device, the fluid solve's
        transform and the warp mode."""
        group = parser.add_argument_group("compute parameters")
        group.add_argument(
            "--device",
            default="cuda",
            type=str,
            help="torch device to run on (cuda, cuda:N or cpu); a CUDA device "
            "runs the hand-written kernels, the CPU their plain versions; in a "
            "multi-process run cuda is cuda:<local rank>",
        )
        group.add_argument(
            "--coordinator_address",
            default=None,
            type=str,
            help="host:port of process 0, for a multi-process run (torch.distributed "
            "over TCP; without it the torchrun variables WORLD_SIZE, RANK and "
            "MASTER_ADDR are read)",
        )
        group.add_argument(
            "--num_processes",
            default=None,
            type=int,
            help="Total number of processes, for a multi-process run",
        )
        group.add_argument(
            "--process_id",
            default=None,
            type=int,
            help="This process's rank, for a multi-process run",
        )
        group.add_argument(
            "--fluid_transform",
            default="auto",
            choices=["auto", "mxu", "radix", "packed", "fft", "dft"],
            help="Fluid-solve transform: auto (the packed solve on kernel K3 "
            "for 3D fields with beta = 0, rfftn otherwise), mxu (K3, or K16 "
            "under set_fluid_mxu_whole), radix (K14, K15 on power-of-two "
            "axes), packed (packed pairs on torch.fft), fft (rfftn), dft "
            "(tensordot with DFT matrices)",
        )
        group.add_argument(
            "--warp_mode",
            default="auto",
            choices=["auto", "unit", "bounded", "general"],
            help="Global warp-tier mode (set_warp_mode): auto = runtime tiering "
            "and the unit-regime kernels; unit, bounded and general force that "
            "tier, and bounded and general keep the unit-regime kernels and the "
            "hoisted shooting off (debug/parity)",
        )

    def _initialize_compute(self, args):
        """Start the process group of a multi-process run, check the device,
        set the fluid-solve selectors and the global warp mode, and build
        the mesh: over every visible CUDA device when one process sees more
        than one (the JAX package's rule), else None.

        A multi-process run (``--coordinator_address``, or the torchrun
        variables) initialises ``torch.distributed`` with the backend
        ``"cpu:gloo,cuda:nccl"`` on the card (host float64 sums go over
        gloo, device tensors over NCCL) and ``gloo`` with ``--device cpu``;
        ``--device cuda`` then means ``cuda:<local rank>``."""
        import torch

        from .ops.fluid import set_fluid_dft, set_fluid_fft_kernel, set_fluid_packing
        from .ops.interp import set_warp_mode

        device = torch.device(getattr(args, "device", "cuda"))
        _init_process_group(args, device)
        if process_count() > 1 and device.type == "cuda" and device.index is None:
            local = int(os.environ.get("LOCAL_RANK", process_index()))
            device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
        if device.type != "cpu" and not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {device}: no CUDA device (torch.cuda.is_available() is "
                "false); pass --device cpu to run the plain versions on the CPU"
            )
        wm = getattr(args, "warp_mode", "auto")
        if wm != "auto":
            set_warp_mode(wm)
        ft = getattr(args, "fluid_transform", "auto")
        if ft in ("mxu", "radix"):
            set_fluid_fft_kernel(ft)
        elif ft != "auto":
            # every other choice bypasses the solve's kernels
            set_fluid_fft_kernel(False)
            if ft == "dft":
                set_fluid_dft(True)
            else:
                set_fluid_packing(ft == "packed")
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)  # the current device of NCCL's collectives
        self.device = device
        self.rank = process_index()
        self.world_size = process_count()
        from .parallel import get_mesh

        single = self.world_size == 1 and device.type == "cuda"
        self.mesh = get_mesh() if single and torch.cuda.device_count() > 1 else None

    def _stamp_dataset(self, ds, args):
        """Stamp provenance attributes on an output HDF5 dataset."""
        from . import __version__

        ds.attrs["lagomorph_version"] = __version__
        ds.attrs["command_args"] = json.dumps(
            {k: v for k, v in vars(args).items() if not k.startswith("_")}
        )


def _init_process_group(args, device):
    """Initialise the default process group from the command's flags or
    from the torchrun environment, when either asks for one and none is up."""
    import datetime

    import torch.distributed as dist

    addr = getattr(args, "coordinator_address", None)
    if addr:
        init = f"tcp://{addr}"
        world, rank = args.num_processes, args.process_id
        if world is None or rank is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return
    if dist.is_initialized():
        return
    backend = "gloo" if device.type == "cpu" else "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend, init_method=init, world_size=int(world), rank=int(rank),
                            timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
