"""Progress bars and the command-line tooling of the port.

Port of ``lagomorph_tpu/utils.py``: :class:`Tool`, the base of the
two-level command line (``python -m lagomorph_tpu_torch <module> <command>``),
with its compute arguments and the provenance stamp of output files.  The
JAX package's runtime and multi-host arguments (``--platform``,
``--coordinator_address``, ``--num_processes``, ``--process_id``) have no
meaning here; ``--device`` takes their place.  ``tqdm`` is optional: it is
imported only when a progress bar is shown.
"""
from __future__ import annotations

import argparse
import json
import sys

__all__ = ["Tool", "progress", "torch_device"]


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
            "runs the hand-written kernels, the CPU their plain versions",
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
        """Check the device and set the fluid-solve selectors and the
        global warp mode.  One process on one device: ``rank`` 0,
        ``world_size`` 1, no mesh."""
        import torch

        from .ops.fluid import set_fluid_dft, set_fluid_fft_kernel, set_fluid_packing
        from .ops.interp import set_warp_mode

        device = torch.device(getattr(args, "device", "cuda"))
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
        self.device = device
        self.rank = 0
        self.world_size = 1
        self.mesh = None

    def _stamp_dataset(self, ds, args):
        """Stamp provenance attributes on an output HDF5 dataset."""
        from . import __version__

        ds.attrs["lagomorph_version"] = __version__
        ds.attrs["command_args"] = json.dumps(
            {k: v for k, v in vars(args).items() if not k.startswith("_")}
        )
