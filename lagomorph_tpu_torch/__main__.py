"""Top-level command line: ``python -m lagomorph_tpu_torch <module> <command>
[args]``, the JAX package's three modules: ``affine`` (``affine atlas``,
``affine standardize``), ``data`` (``average``, ``crop``, ``downscale``,
``numexpr``, ``split``, ``splitcv``; host only, no ``--device``) and
``lddmm`` (``lddmm atlas``).
"""
import sys

from .utils import Tool


class LagomorphTool(Tool):
    """Command line interface to lagomorph_tpu_torch commands"""

    module_name = "lagomorph_tpu_torch"
    subcommands = ["affine", "data", "lddmm"]

    def _subtool(self, command):
        if command == "affine":
            from .affine import _Tool
        elif command == "data":
            from .data import _Tool
        elif command == "lddmm":
            from .lddmm import _Tool
        else:  # pragma: no cover
            raise ValueError(command)
        return _Tool

    def call_subcommand(self, command):
        del sys.argv[1]  # the module's tool reads its own command first
        return self._subtool(command)().run()

    def describe_subcommand(self, command):
        return self._subtool(command).__doc__


def main():
    LagomorphTool().run()


if __name__ == "__main__":
    main()
