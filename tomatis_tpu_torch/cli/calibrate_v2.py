"""CLI: calibrator v2 (`tomatis calibrate-v2`)."""
import sys

from tomatis_tpu_torch.cli.calibrate import v2_main as main  # noqa: F401

if __name__ == "__main__":
    sys.exit(main())
