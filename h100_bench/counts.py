"""The one yardstick of work: operations and bytes from a configuration's
shapes alone, and the card's published peaks.

Nothing here looks at what implements the work, so a change that fuses,
removes or replaces a kernel leaves every count as it was.

- A forward of the score UNet counts every conv (2 k^2 Cin Cout Hout Wout),
  every linear layer (2 fin fout a row) and each attention's two products
  (4 B T^2 C). Norms, activations and other elementwise work are not
  counted. A training sample counts three forwards.
- An attention forward reads q, k, v once and writes o once; its backward
  reads q, k, v, dO and writes dQ, dK, dV, with 10 B T^2 C operations (the
  scores recomputed, and the four products of the gradient).
- Peaks: one NVIDIA H100 SXM, dense bf16 989e12 FLOP/s, HBM 3.35e12 B/s
  (NVIDIA's data sheet, at its 700 W power limit).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _conv(k: int, cin: int, cout: int, h: int, w: int) -> int:
    return 2 * k * k * cin * cout * h * w


def _linear(fin: int, fout: int, rows: int = 1) -> int:
    return 2 * fin * fout * rows


def attention_calls(model: dict, height: int, width: int) -> list:
    """``(T, C)`` of every attention call of one forward, in order: two
    blocks' worth (down and up) at each attention level."""
    stride = int(model.get("stride", 2))
    calls = []
    for i, (c, blocks) in enumerate(zip(model["hidden_channels"], model["hidden_blocks"])):
        if i in model.get("attention_levels", ()):
            t = (height // stride**i) * (width // stride**i)
            calls += [(t, int(c))] * (2 * int(blocks))
    return calls


def forward_flops(model: dict, height: int, width: int) -> int:
    """Operations of one ScoreUNet forward of one window [1, H, W, channels]."""
    k = int(model.get("kernel_size", 3))
    stride = int(model.get("stride", 2))
    hc = [int(c) for c in model["hidden_channels"]]
    blocks = [int(b) for b in model["hidden_blocks"]]
    emb = int(model.get("embedding_dim", 512))
    nf = int(model.get("noise_features", 32))
    ch = int(model["channels"])
    total = _linear(nf, emb) + _linear(emb, emb)  # the noise embedding's two layers
    for i, c in enumerate(hc):
        h, w = height // stride**i, width // stride**i
        total += _conv(k, ch if i == 0 else hc[i - 1], c, h, w)  # head i, at its output size
        per_block = _linear(emb, c) + 2 * _conv(k, c, c, h, w)
        total += 2 * blocks[i] * per_block  # down and up
        total += _conv(k, c, ch if i == 0 else hc[i - 1],  # tail i at the level above
                       h * stride if i else h, w * stride if i else w)
    for t, c in attention_calls(model, height, width):
        total += _linear(c, 3 * c, t) + _linear(c, c, t) + 4 * t * t * c
    return total


def train_sample_flops(model: dict, height: int, width: int) -> int:
    """A training sample: the forward and a backward counted as two more."""
    return 3 * forward_flops(model, height, width)


def attention_fwd_work(batch: int, seq: int, ch: int, itemsize: int = 2) -> tuple:
    """``(flops, bytes)`` of one attention forward over [batch, seq, ch]."""
    return 4 * batch * seq * seq * ch, 4 * batch * seq * ch * itemsize


def attention_bwd_work(batch: int, seq: int, ch: int, itemsize: int = 2) -> tuple:
    """``(flops, bytes)`` of one attention backward over [batch, seq, ch]."""
    return 10 * batch * seq * seq * ch, 7 * batch * seq * ch * itemsize


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
