"""Model summary and memory accounting (port of
climate2weather_tpu/utils/summary.py).

Parity: the reference's hook-based ``print_module_summary`` and
``count_parameters_and_buffers`` (util.py:156-247,271-287). The JAX package
groups its params pytree by the first two levels of each leaf's flax path;
the port names its parameters through ``convert.flax_path`` (the snapshot's
names: ``unet/down0_block0``, ``map_layer0/kernel``, ...), so it prints the
same groups with the same counts. :func:`tabulate_module` lists each
module's output shape and parameters from one forward with hooks.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from climate2weather_tpu_torch.convert import flax_path


def param_counts(module: nn.Module) -> Dict[str, int]:
    """Parameter count per top-level module path (the first two levels of
    the flax path)."""
    counts: Dict[str, int] = {}
    for name, p in module.named_parameters():
        keys = flax_path(name, p.shape)
        group = "/".join(keys[:2])
        counts[group] = counts.get(group, 0) + p.numel()
    return counts


def print_module_summary(module: nn.Module, name: str = "model") -> int:
    """Print a per-module parameter table; returns the total count
    (reference util.print_module_summary, util.py:156-247)."""
    counts = param_counts(module)
    total = sum(counts.values())
    width = max((len(k) for k in counts), default=10)
    print(f"{name} parameter summary")
    print("-" * (width + 16))
    for k in sorted(counts):
        print(f"{k:<{width}}  {counts[k]:>12,}")
    print("-" * (width + 16))
    print(f"{'TOTAL':<{width}}  {total:>12,}  ({total / 1e6:.2f}M)")
    return total


def _shape(out) -> str:
    if isinstance(out, torch.Tensor):
        return str(list(out.shape))
    if isinstance(out, (tuple, list)):
        return "(" + ", ".join(_shape(o) for o in out) + ")"
    return type(out).__name__


def tabulate_module(module: nn.Module, *example_args, **kwargs) -> str:
    """One forward of ``module`` on the example inputs under hooks, as a
    table: each submodule's path, class, output shape and own parameter
    count, in the order the modules ran, and the total (the detailed
    analogue of the reference's hook-based module summary)."""
    rows: List[tuple] = []
    hooks = []
    for path, sub in module.named_modules():
        def hook(m, args, out, path=path):
            rows.append((path or "<root>", type(m).__name__, _shape(out),
                         sum(p.numel() for p in m.parameters(recurse=False))))
        hooks.append(sub.register_forward_hook(hook))
    try:
        with torch.no_grad():
            module(*example_args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    head = ("module", "class", "output shape", "params")
    widths = [max(len(str(r[i])) for r in rows + [head]) for i in range(4)]
    line = "  ".join("-" * w for w in widths)
    out = ["  ".join(str(c).ljust(w) for c, w in zip(head, widths)), line]
    out += ["  ".join([str(r[0]).ljust(widths[0]), r[1].ljust(widths[1]), r[2].ljust(widths[2]),
                       f"{r[3]:,}".rjust(widths[3])]) for r in rows]
    out += [line, f"total parameters: {sum(p.numel() for p in module.parameters()):,}"]
    return "\n".join(out)


def tree_bytes(tree) -> int:
    """Total bytes of every tensor in ``tree``: a tensor, a module (its
    parameters and buffers), an optimizer (its state), or nested dicts,
    lists and tuples of them."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, nn.Module):
        return sum(tree_bytes(t) for t in (*tree.parameters(), *tree.buffers()))
    if isinstance(tree, torch.optim.Optimizer):
        return tree_bytes(list(tree.state.values()))
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def training_memory_report(state) -> Dict[str, float]:
    """MB per training-state component of a ``training.state.TrainState``
    (reference util.py:271-287)."""
    report = {
        "params_MB": tree_bytes(state.net) / 2**20,
        "opt_state_MB": tree_bytes(state.optimizer) / 2**20,
        "emas_MB": tree_bytes(state.emas) / 2**20,
    }
    report["total_MB"] = sum(report.values())
    return report
