"""The score UNet in plain PyTorch, written from the architecture alone.

Parameters are a dict of float32 tensors named by their flax paths with
dots (``unet.down0_block1.conv0.weight``): conv weights [O, I, k, k],
linear weights [out, in], as the snapshot's tree gives them after the
usual transposes (:mod:`snapshot`). The network, for ``channels``
input channels, ``hidden_channels`` [c_0 .. c_{n-1}], ``hidden_blocks``,
``attention_levels`` and ``embedding_dim``:

- noise embedding: t -> [cos(t f), sin(t f)], f_j = 10000^(-j / (nf/2)),
  -> linear -> SiLU -> linear -> SiLU;
- level i down: head conv (stride 1 at level 0, else 2), then per block
  x + conv1(SiLU(conv0(norm(x + W_i emb)))), each block followed by an
  attention block at an attention level; the output kept for the skip;
- level i up, from the deepest: the same blocks, then (i > 0) norm,
  nearest upsample by 2, tail conv, plus the skip of level i - 1; at
  level 0 the tail conv alone;
- norm: standardise over channels, population variance, eps 1e-5;
- attention (one head over the H W positions): x + proj(softmax(q k^T /
  sqrt(C)) v) with q, k, v from a linear layer of the normed x.

``cast`` is applied where a lower-precision program holds a tensor: every
conv and linear layer's input, weight and output, and each norm's and
attention's output. The reference proper passes the identity and runs in
float32 with TF32 off; the control passes a rounding to a lower precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _straight_through(x: torch.Tensor, held: torch.Tensor) -> torch.Tensor:
    """``held`` forward, x's gradient backward."""
    return x + (held - x).detach()


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x held as float8 e4m3 with one scale for the tensor (its largest
    magnitude onto e4m3's 448), back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return _straight_through(x, (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return _straight_through(x, x.detach().to(torch.bfloat16).float())


CASTS = {"fp32": identity, "bf16": bf16_round, "fp8": fp8_round}


class ReferenceUNet:
    """A callable ``(x [B, H, W, channels], t [B] or a float) -> eps``."""

    def __init__(self, model: dict, params: dict, cast=identity):
        self.model = model
        self.p = params
        self.cast = cast
        self.hc = [int(c) for c in model["hidden_channels"]]
        self.blocks = [int(b) for b in model["hidden_blocks"]]
        self.attn = set(int(i) for i in model.get("attention_levels", ()))
        self.k = int(model.get("kernel_size", 3))
        self.stride = int(model.get("stride", 2))
        self.nf = int(model.get("noise_features", 32))

    def conv(self, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        c = self.cast
        out = F.conv2d(c(x), c(self.p[name + ".weight"]), self.p[name + ".bias"], stride=stride,
                       padding=self.k // 2)
        return c(out)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        c = self.cast
        return c(F.linear(c(x), c(self.p[name + ".weight"]), self.p[name + ".bias"]))

    def norm(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        mean = x.mean(dim=dim, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=dim, keepdim=True)
        return self.cast((x - mean) / torch.sqrt(var + 1e-5))

    def embedding(self, t: torch.Tensor) -> torch.Tensor:
        half = self.nf // 2
        freqs = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=torch.float32,
                                                               device=t.device) / half)
        args = t.reshape(-1, 1).float() * freqs[None, :]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        emb = F.linear(emb, self.p["map_layer0.weight"], self.p["map_layer0.bias"])
        emb = F.linear(F.silu(emb), self.p["map_layer1.weight"], self.p["map_layer1.bias"])
        return self.cast(F.silu(emb))

    def block(self, name: str, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = x + self.linear(name + ".project", emb)[:, :, None, None]
        h = self.conv(name + ".conv0", self.norm(h))
        h = self.conv(name + ".conv1", self.cast(F.silu(h)))
        return self.cast(x + h)

    def attention(self, name: str, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.linear(name + ".qkv", self.norm(h, dim=-1)).chunk(3, dim=-1)
        w = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        out = self.linear(name + ".proj_out", self.cast(w @ v))
        return self.cast(h + out).reshape(b, hh, ww, c).permute(0, 3, 1, 2)

    def level(self, x: torch.Tensor, emb: torch.Tensor, i: int, stage: str) -> torch.Tensor:
        for bi in range(self.blocks[i]):
            x = self.block(f"unet.{stage}{i}_block{bi}", x, emb)
            if i in self.attn:
                x = self.attention(f"unet.{stage}{i}_attn{bi}", x)
        return x

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1)
        emb = self.embedding(t)
        if emb.shape[0] == 1 and x.shape[0] != 1:
            emb = emb.expand(x.shape[0], -1)
        h = x.permute(0, 3, 1, 2).float()
        skips = []
        n = len(self.hc)
        for i in range(n):
            h = self.conv(f"unet.head{i}", h, stride=1 if i == 0 else self.stride)
            h = self.level(h, emb, i, "down")
            skips.append(h)
        skips.pop()
        for i in reversed(range(n)):
            h = self.level(h, emb, i, "up")
            if i > 0:
                h = F.interpolate(self.norm(h), scale_factor=self.stride, mode="nearest")
                h = self.cast(self.conv(f"unet.tail{i}", h) + skips.pop())
            else:
                h = self.conv("unet.tail0", h)
        return h.permute(0, 2, 3, 1)


def param_shapes(model: dict) -> dict:
    """Name -> shape of every parameter of the network ``model`` describes,
    in the order the program's modules register them."""
    k = int(model.get("kernel_size", 3))
    hc = [int(c) for c in model["hidden_channels"]]
    blocks = [int(b) for b in model["hidden_blocks"]]
    attn = set(int(i) for i in model.get("attention_levels", ()))
    emb, nf, ch = int(model.get("embedding_dim", 512)), int(model.get("noise_features", 32)), int(model["channels"])
    shapes = {}

    def linear(name, fin, fout):
        shapes[name + ".weight"], shapes[name + ".bias"] = (fout, fin), (fout,)

    def conv(name, cin, cout):
        shapes[name + ".weight"], shapes[name + ".bias"] = (cout, cin, k, k), (cout,)

    linear("map_layer0", nf, emb)
    linear("map_layer1", emb, emb)
    for i, c in enumerate(hc):
        conv(f"unet.head{i}", ch if i == 0 else hc[i - 1], c)
    for stage in ("down", "up"):
        for i, c in enumerate(hc):
            for bi in range(blocks[i]):
                linear(f"unet.{stage}{i}_block{bi}.project", emb, c)
                conv(f"unet.{stage}{i}_block{bi}.conv0", c, c)
                conv(f"unet.{stage}{i}_block{bi}.conv1", c, c)
                if i in attn:
                    linear(f"unet.{stage}{i}_attn{bi}.qkv", c, 3 * c)
                    linear(f"unet.{stage}{i}_attn{bi}.proj_out", c, c)
    for i, c in enumerate(hc):
        conv(f"unet.tail{i}", c, ch if i == 0 else hc[i - 1])
    return shapes
