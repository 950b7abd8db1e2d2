"""Data-loading benchmark entry (`MViT/tools/benchmark.py`, the JAX
package's `tools/benchmark.py`).

    python -m pmv_tpu_torch.tools.benchmark --cfg <yaml> [--opts KEY VALUE ...]

Runs ``utils/benchmark.py::benchmark_data_loading`` on each config: the
train loader alone, on the host, with BENCHMARK.NUM_EPOCHS, LOG_PERIOD and
SHUFFLE. It touches no device.
"""

import sys

from pmv_tpu_torch.config.defaults import assert_and_infer_cfg
from pmv_tpu_torch.config.parser import load_config, parse_args
from pmv_tpu_torch.utils.benchmark import benchmark_data_loading


def main(argv=None):
    args = parse_args(argv)
    for path in args.cfg_files or [None]:
        benchmark_data_loading(assert_and_infer_cfg(load_config(args, path)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
