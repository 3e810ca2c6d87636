"""`python -m karpenter_tpu_torch.operator`: run the operator against the kwok
simulated provider (the reference's kwok/main.go:33-48).

It takes the options' flags (operator/options.py) plus ``--device``: the
solves run on the card unless it names another device (``--device cpu``
runs the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import sys

from .operator import Operator
from .options import parse_options


def main(argv=None) -> int:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    known, rest = pre.parse_known_args(
        argv if argv is not None else sys.argv[1:])
    options = parse_options(rest)
    op = Operator(options, device=known.device)
    print(f"karpenter-tpu operator starting "
          f"(provider={op.cloud_provider.name}, "
          f"backend={options.solver_backend}, device={op.device})",
          flush=True)
    try:
        op.run()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
