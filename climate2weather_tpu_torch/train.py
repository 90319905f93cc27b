"""Training CLI (port of the repository's ``train.py``).

    python -m climate2weather_tpu_torch.train --run-dir RUNS --run-id ID \\
        --train-data train.h5 --spatial-res 128 --num-features 4 [--device cpu] ...

The same flags, ndata suffixes (Ki/Mi/Gi) and config assembly as the JAX
CLI's ``fabricless_main``: the run directory ``RUN_DIR/RUN_ID[-DESC]`` gets
a frozen ``opts.yaml`` and ``config.yaml`` (written by the package's own
YAML writer) and the run itself (``training.loop.training_loop``). Flags are
parsed with ``argparse``. The reference CLI's device flags are accepted and
ignored; ``--device`` picks the card (the default) or the CPU.
"""

from __future__ import annotations

import argparse
import os

from climate2weather_tpu_torch.io.snapshot import yaml_dump_file, yaml_load_file
from climate2weather_tpu_torch.utils.easydict import EasyDict
from climate2weather_tpu_torch.utils.ndata import parse_ndata

_IGNORED = ("accelerator", "devices", "num_nodes", "strategy")


def _int_at_least(low: int):
    def parse(text: str) -> int:
        v = int(text)
        if v < low:
            raise argparse.ArgumentTypeError(f"{v} is smaller than {low}")
        return v

    return parse


def _positive_float(text: str) -> float:
    v = float(text)
    if not v > 0:
        raise argparse.ArgumentTypeError(f"{v} is not > 0")
    return v


def _flag_pair(ap, name: str, dest: str, default: bool, off: str = None):
    """``--name/--no-name`` (or ``--name/--off``) as click writes them."""
    group = ap.add_mutually_exclusive_group()
    group.add_argument(f"--{name}", dest=dest, action="store_true")
    group.add_argument(f"--{off or 'no-' + name}", dest=dest, action="store_false")
    ap.set_defaults(**{dest: default})


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for flag in _IGNORED:  # reference-CLI device flags, accepted and ignored
        ap.add_argument(f"--{flag.replace('_', '-')}", dest=flag, default=None,
                        help=argparse.SUPPRESS)
    ap.add_argument("--run-dir", required=True, help="Where to save the results")
    ap.add_argument("--run-id", required=True, help="Unique identifier for the run")
    ap.add_argument("--desc", default=None, help="String to include in result dir name")
    ap.add_argument("--train-data", required=True, help="Path to the training .h5 dataset")
    ap.add_argument("--valid-data", default=None, help="Path to the validation dataset")
    ap.add_argument("--spatial-res", type=_int_at_least(4), required=True)
    ap.add_argument("--num-features", type=_int_at_least(1), required=True)
    _flag_pair(ap, "cache-data", "cache_data", False)
    ap.add_argument("--markov-order", type=_int_at_least(1), default=3)
    ap.add_argument("--model-config", default="configs/sda_unet.yml")
    ap.add_argument("--lr", type=_positive_float, default=2e-4)
    ap.add_argument("--total-ndata", type=parse_ndata, default="15Mi")
    ap.add_argument("--batch", type=_int_at_least(1), default=128)
    ap.add_argument("--batch-gpu", type=_int_at_least(1), default=None,
                    help="Per-device microbatch limit")
    ap.add_argument("--status", type=parse_ndata, default="20Ki")
    ap.add_argument("--snapshot", type=parse_ndata, default="1Mi")
    ap.add_argument("--checkpoint", type=parse_ndata, default="2Mi")
    ap.add_argument("--logging", dest="logging_", type=parse_ndata, default="5Ki")
    ap.add_argument("--valid", type=parse_ndata, default="1Mi")
    ap.add_argument("--slice-data", dest="slice_data", type=parse_ndata, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ema-rates", default="0.9999", help="Comma-separated EMA rates")
    _flag_pair(ap, "log-alldevices", "log_alldevices", False, off="log-firstdevice")
    _flag_pair(ap, "wandb", "use_wandb", False)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None) -> None:
    opts = vars(build_parser().parse_args(argv))
    for flag in _IGNORED:
        if opts.pop(flag, None) is not None:
            print(
                f"NOTE: --{flag.replace('_', '-')} is accepted for reference-CLI "
                f"compatibility but ignored (one card, or the CPU with --device cpu)."
            )
    fabricless_main(**opts)


def fabricless_main(
    run_dir, run_id, desc, train_data, valid_data, spatial_res, num_features,
    cache_data, markov_order, model_config, lr, total_ndata, batch, batch_gpu,
    status, snapshot, checkpoint, logging_, valid, slice_data, seed, ema_rates,
    log_alldevices, use_wandb, device="cuda",
):
    from climate2weather_tpu_torch.training.loop import training_loop
    from climate2weather_tpu_torch.utils.logging import RunLogger

    opts = EasyDict(locals())

    # -- run dir + frozen opts (reference train.py:103-121) ----------------
    cur_run_dir = os.path.join(run_dir, str(run_id) + (f"-{desc}" if desc else ""))
    os.makedirs(cur_run_dir, exist_ok=True)
    yaml_dump_file({k: v for k, v in opts.items() if not callable(v)},
                   os.path.join(cur_run_dir, "opts.yaml"))

    # -- config assembly (reference train.py:128-196) ----------------------
    cfg = EasyDict()
    window = 2 * markov_order + 1
    common_dataset_kwargs = dict(
        class_name="cosmo_dataset", num_features=num_features, spatial_res=spatial_res,
        cached=cache_data, window=window, flatten=True,
    )
    cfg.dataset_kwargs = EasyDict()
    cfg.dataset_kwargs.train = EasyDict(data_path=train_data, **common_dataset_kwargs)
    if valid_data is not None:
        cfg.dataset_kwargs.valid = EasyDict(data_path=valid_data, **common_dataset_kwargs)
    cfg.total_ndata = total_ndata
    cfg.batch_size = batch
    cfg.batch_gpu = batch_gpu
    cfg.log_ndata = logging_
    cfg.valid_ndata = valid
    cfg.snapshot_ndata = snapshot
    cfg.checkpoint_ndata = checkpoint
    cfg.status_ndata = status
    cfg.slice_ndata = slice_data
    cfg.seed = seed
    mdl_conf = yaml_load_file(model_config)
    # torch-only keys of reference YAMLs (padding_mode) are ignored
    cfg.network_kwargs = EasyDict(
        class_name="score_unet", channels=num_features * window,
        **{k: v for k, v in mdl_conf.items() if k != "padding_mode"},
    )
    cfg.optimizer_kwargs = EasyDict(class_name="adamw", lr=lr, weight_decay=1e-3,
                                    betas=[0.9, 0.999])
    cfg.pipeline_kwargs = EasyDict(class_name="vp_cosine")
    cfg.ema_kwargs = EasyDict(class_name="standard_ema",
                              rates=[float(r) for r in str(ema_rates).split(",")])
    cfg.lr_kwargs = EasyDict(func_name="lr/linear", ref_lr=lr, total_ndata=total_ndata)
    cfg.run_dir = cur_run_dir
    yaml_dump_file(cfg.to_plain(), os.path.join(cur_run_dir, "config.yaml"))

    logger = RunLogger(cur_run_dir, enabled=True, use_wandb=use_wandb,
                       run_id=f"{run_id}-0" if log_alldevices else run_id,
                       config=cfg.to_plain(), rank=0)
    training_loop(
        cur_run_dir,
        dataset_kwargs=cfg.dataset_kwargs,
        network_kwargs=cfg.network_kwargs,
        pipeline_kwargs=cfg.pipeline_kwargs,
        optimizer_kwargs=cfg.optimizer_kwargs,
        lr_kwargs=cfg.lr_kwargs,
        batch_size=cfg.batch_size,
        batch_gpu=cfg.batch_gpu,
        total_ndata=cfg.total_ndata,
        log_ndata=cfg.log_ndata,
        status_ndata=cfg.status_ndata,
        snapshot_ndata=cfg.snapshot_ndata,
        checkpoint_ndata=cfg.checkpoint_ndata,
        valid_ndata=cfg.valid_ndata,
        ema_kwargs=cfg.ema_kwargs,
        slice_ndata=cfg.slice_ndata,
        seed=cfg.seed,
        logger=logger,
        device=device,
    )
    logger.finish()
    print("Training complete.")


if __name__ == "__main__":
    main()
