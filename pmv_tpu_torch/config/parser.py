"""CLI argument parsing.

Mirrors the reference's `--shard_id --num_shards --init_method --cfg --opts`
surface (`MViT/slowfast/utils/parser.py:13-94`) so the `exps/PMV` launch
scripts port with only a device flag.
"""

import argparse
import sys

from pmv_tpu_torch.config.defaults import assert_and_infer_cfg, get_cfg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="PMV-TPU video understanding train/test/demo entry"
    )
    parser.add_argument(
        "--shard_id",
        help="The shard (host) id of the current machine.",
        default=0,
        type=int,
    )
    parser.add_argument(
        "--num_shards",
        help="Number of shards (hosts) in the job.",
        default=1,
        type=int,
    )
    parser.add_argument(
        "--init_method",
        help="Coordinator rendezvous address, e.g. tcp://host:port "
        "(maps to jax.distributed.initialize coordinator_address).",
        default="tcp://localhost:9999",
        type=str,
    )
    parser.add_argument(
        "--cfg",
        dest="cfg_files",
        help="Path(s) to the config file(s)",
        default=None,
        nargs="+",
    )
    parser.add_argument(
        "--opts",
        help="See pmv_tpu/config/defaults.py for all options",
        default=None,
        nargs=argparse.REMAINDER,
    )
    if argv is None and len(sys.argv) == 1:
        parser.print_help()
    return parser.parse_args(argv)


def load_config(args, path_to_config=None):
    """Build a cfg from defaults <- yaml file <- CLI opts <- shard args."""
    cfg = get_cfg()
    if path_to_config is not None:
        cfg.merge_from_file(path_to_config)
    if args.opts is not None and len(args.opts) > 0:
        cfg.merge_from_list(args.opts)

    if hasattr(args, "num_shards") and hasattr(args, "shard_id"):
        cfg.NUM_SHARDS = args.num_shards
        cfg.SHARD_ID = args.shard_id
    if hasattr(args, "init_method"):
        addr = args.init_method
        if addr.startswith("tcp://"):
            addr = addr[len("tcp://"):]
        cfg.TPU.COORDINATOR_ADDRESS = addr

    return cfg
