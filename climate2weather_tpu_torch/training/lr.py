"""Learning-rate schedules parameterized by ndata, examples seen (port of
climate2weather_tpu/training/lr.py)."""

from __future__ import annotations

import math

from climate2weather_tpu_torch.utils.registry import get_obj_by_name, register


@register("lr/linear")
def linear_learning_rate_schedule(cur_ndata, total_ndata, ref_lr):
    return ref_lr * (1.0 - cur_ndata / total_ndata)


@register("lr/edm2")
def edm2_learning_rate_schedule(cur_ndata, batch_size, ref_lr, ref_batches, rampup_Mdata):
    lr = float(ref_lr)
    if ref_batches > 0:
        lr = lr / math.sqrt(max(cur_ndata / (ref_batches * batch_size), 1.0))
    if rampup_Mdata > 0:
        lr = lr * min(cur_ndata / (rampup_Mdata * 1e6), 1.0)
    return lr


def make_schedule(lr_kwargs: dict, batch_size: int):
    """``step -> lr`` from a config dict with ``func_name`` and its kwargs;
    ``cur_ndata = step * batch_size``."""
    kwargs = dict(lr_kwargs)
    fn = get_obj_by_name(kwargs.pop("func_name"))

    def schedule(step):
        return float(fn(cur_ndata=step * batch_size, **kwargs))

    return schedule
