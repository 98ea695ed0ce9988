"""CLI: head trimmer (`tomatis cut`, ref src/cut_tomatis_d.py)."""
import sys

from tomatis_tpu_torch.cli.repair import cut_main as main  # noqa: F401

if __name__ == "__main__":
    sys.exit(main())
