"""Plain PyTorch reference of the two training steps, in float32.

The step of each configuration as its paper and the reference
implementation define it, over the networks of ``nets.py``:

* pix2pix: ``fake_B = G(A)`` once; the D step first, ``0.5 (GAN(D(A,
  fake_B.detach())) fake + GAN(D(A, B)) real)``; then the G step, ``GAN(D(A,
  fake_B)) real + lambda_L1 L1(fake_B, B)`` through the updated D; an Adam
  per net with the same learning rate. Batch norm moves G's running
  averages on its forward and D's on each of its three passes.
* CycleGAN: the six G passes (fake, reconstruction and identity of both
  directions), the G step over ``GAN + lambda (cycle) + lambda lambda_idt
  (identity)`` with the Ds held, one Adam over both Gs; then the replay
  pools; then each D on its real batch and its pooled fake, 0.5 weighted,
  one Adam over both Ds. The G passes run as three batched passes and each
  D pair as one, which instance norm (per sample) makes the same function
  as six and four passes.

Adam is optax's ``scale_by_adam`` (b2 0.999, eps 1e-8 outside the root, the
bias corrections ``1 - b**count`` in f32) with ``p -= lr * direction``.

The step's draws follow the configuration's seeding rule, copied here
(``step_generator``, ``dropout_generator``): a CPU generator per (seed,
step); the dropout masks from a device generator seeded by one draw of
it; each pool query draws its coins and slots from it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nets


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws, from (seed, step) alone."""
    return torch.Generator().manual_seed(int(seed) * 1_000_003 + int(step))


def dropout_generator(step_gen: torch.Generator, device) -> torch.Generator:
    """A device generator seeded by one draw of the step's generator."""
    seed = int(torch.randint(0, 2**62, (1,), generator=step_gen))
    return torch.Generator(device=device).manual_seed(seed)


class Adam:
    """optax ``scale_by_adam(b1, 0.999, 1e-8)`` in f32 over a dict of
    parameters, with ``p -= lr * direction``."""

    def __init__(self, params: Dict[str, torch.Tensor], b1: float):
        self.b1, self.b2, self.eps = b1, 0.999, 1e-8
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float):
        self.count += 1
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.count))
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            p -= lr * (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)


def gan_loss(pred: torch.Tensor, real: bool, mode: str) -> torch.Tensor:
    target = torch.full_like(pred, 1.0 if real else 0.0)
    if mode == "vanilla":
        return F.binary_cross_entropy_with_logits(pred, target)
    if mode == "lsgan":
        return F.mse_loss(pred, target)
    raise ValueError(mode)


def l1(a, b):
    return (a - b).abs().mean()


def _grads(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    names = list(params)
    return dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))


def lr_of(cfg) -> float:
    """The constant learning rate of the first epoch, in f32."""
    return float(np.float32(cfg["lr"]))


class Pix2PixRef:
    """The pix2pix training state and step (module docstring)."""

    def __init__(self, cfg, params: Dict[str, Dict[str, torch.Tensor]], buffers, quant=None):
        self.cfg, self.quant = cfg, quant
        self.P = {n: {k: v.clone().requires_grad_(True) for k, v in p.items()}
                  for n, p in params.items()}
        self.buffers = {n: {k: v.clone() for k, v in b.items()} for n, b in buffers.items()}
        self.opts = {n: Adam(self.P[n], cfg["beta1"]) for n in ("G", "D")}

    def step(self, A, B, seed: int, step: int):
        cfg, q = self.cfg, self.quant
        gen = step_generator(seed, step)
        drop = dropout_generator(gen, A.device)
        PG, PD = self.P["G"], self.P["D"]
        bG, bD = self.buffers["G"], self.buffers["D"]
        fake_B = nets.unet_g(PG, bG, A, cfg["ngf"], cfg["unet_downs"], drop, q)

        def D(x):
            return nets.basic_d(PD, bD, x, "batch", True, q)

        pred_fake = D(torch.cat([A, fake_B.detach()], -1))
        pred_real = D(torch.cat([A, B], -1))
        d_fake = gan_loss(pred_fake, False, cfg["gan_mode"])
        d_real = gan_loss(pred_real, True, cfg["gan_mode"])
        grads_D = _grads(0.5 * (d_fake + d_real), PD)
        self.opts["D"].step(PD, grads_D, lr_of(cfg))
        g_gan = gan_loss(D(torch.cat([A, fake_B], -1)), True, cfg["gan_mode"])
        g_l1 = l1(fake_B, B) * cfg["lambda_L1"]
        grads_G = _grads(g_gan + g_l1, PG)
        self.opts["G"].step(PG, grads_G, lr_of(cfg))
        losses = {"G_GAN": g_gan, "G_L1": g_l1, "D_real": d_real, "D_fake": d_fake}
        grads = {n: {f"{n}.{k}": v for k, v in g.items()}
                 for n, g in (("G", grads_G), ("D", grads_D))}
        fakes = {"fake_B": fake_B.detach()}
        return {k: float(v.detach()) for k, v in losses.items()}, grads, fakes


def pool_query(pool: Dict, images: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The replay pool, one image at a time: store while not full; once
    full, with a coin above 0.5 hand back a stored image and keep the new
    one in its slot, else hand back the new one."""
    size = pool["buffer"].shape[0]
    coins = torch.rand(images.shape[0], generator=gen).tolist()
    slots = torch.randint(0, size, (images.shape[0],), generator=gen).tolist()
    out: List[torch.Tensor] = []
    for img, coin, slot in zip(images, coins, slots):
        if pool["count"] < size:
            pool["buffer"][pool["count"]] = img
            pool["count"] += 1
            out.append(img)
        elif coin > 0.5:
            out.append(pool["buffer"][slot].clone())
            pool["buffer"][slot] = img
        else:
            out.append(img)
    return torch.stack(out)


class CycleGANRef:
    """The CycleGAN training state and step (module docstring). With
    ``chunk``, each pass runs on micro-batches of that many samples, the
    losses weighted by their share of the batch and the gradients summed,
    so that a large batch fits: instance norm is per sample, so this is the
    same function."""

    def __init__(self, cfg, params: Dict[str, Dict[str, torch.Tensor]], crop: int, device,
                 quant=None, chunk: int = 0):
        self.cfg, self.quant, self.chunk = cfg, quant, chunk
        self.P = {n: {k: v.clone().requires_grad_(True) for k, v in p.items()}
                  for n, p in params.items()}
        self.opts = {
            "G": Adam({**_prefixed(self.P, "G_A"), **_prefixed(self.P, "G_B")}, cfg["beta1"]),
            "D": Adam({**_prefixed(self.P, "D_A"), **_prefixed(self.P, "D_B")}, cfg["beta1"]),
        }
        shape = (cfg["pool_size"], crop, crop, cfg["output_nc"])
        self.pools = {k: {"buffer": torch.zeros(shape, device=device), "count": 0}
                      for k in ("fake_B", "fake_A")}

    def G(self, name, x):
        c = self.cfg
        return nets.resnet_g(self.P[name], x, nets.resnet_blocks(c["netG"]), "reflect",
                             "tanh", self.quant)

    def D(self, name, x):
        return nets.basic_d(self.P[name], {}, x, "instance", quant=self.quant)

    def _accumulate(self, batch: int, params, fn):
        """Sum over the micro-batches ``[s, e)`` of ``fn(s, e) -> (losses,
        extra)`` weighted by ``(e - s) / batch``: the losses' values, the
        gradients of their sum, and the extras in order."""
        size = self.chunk or batch
        total, grads, extras = {}, {k: torch.zeros_like(v) for k, v in params.items()}, []
        for s in range(0, batch, size):
            e = min(s + size, batch)
            losses, extra = fn(s, e)
            w = (e - s) / batch
            for k, g in _grads(sum(losses.values()) * w, params).items():
                grads[k] += g
            for k, v in losses.items():
                total[k] = total.get(k, 0.0) + float(v.detach()) * w
            extras.append(extra)
        return total, grads, extras

    def step(self, A, B, seed: int, step: int):
        c = self.cfg
        gen = step_generator(seed, step)
        lam_A, lam_B, lam_idt, mode = c["lambda_A"], c["lambda_B"], c["lambda_identity"], c["gan_mode"]

        def g_losses(s, e):
            a, b_, n = A[s:e], B[s:e], e - s
            out1 = self.G("G_A", torch.cat([a, b_]))
            fake_B, idt_A = out1[:n], out1[n:]
            out2 = self.G("G_B", torch.cat([b_, fake_B, a]))
            fake_A, rec_A, idt_B = out2[:n], out2[n:2 * n], out2[2 * n:]
            rec_B = self.G("G_A", fake_A)
            return {
                "idt_A": l1(idt_A, b_) * lam_B * lam_idt,
                "idt_B": l1(idt_B, a) * lam_A * lam_idt,
                "G_A": gan_loss(self.D("D_A", fake_B), True, mode),
                "G_B": gan_loss(self.D("D_B", fake_A), True, mode),
                "cycle_A": l1(rec_A, a) * lam_A,
                "cycle_B": l1(rec_B, b_) * lam_B,
            }, (fake_B.detach(), fake_A.detach())

        params_G = {**_prefixed(self.P, "G_A"), **_prefixed(self.P, "G_B")}
        loss, grads_G, fakes = self._accumulate(A.shape[0], params_G, g_losses)
        self.opts["G"].step(params_G, grads_G, lr_of(c))
        fake_B = torch.cat([f[0] for f in fakes])
        fake_A = torch.cat([f[1] for f in fakes])
        with torch.no_grad():
            fake_B_q = pool_query(self.pools["fake_B"], fake_B, gen)
            fake_A_q = pool_query(self.pools["fake_A"], fake_A, gen)

        def d_pair(name, real, fake):
            pr, pf = torch.chunk(self.D(name, torch.cat([real, fake])), 2)
            return 0.5 * (gan_loss(pr, True, mode) + gan_loss(pf, False, mode))

        def d_losses(s, e):
            return {"D_A": d_pair("D_A", B[s:e], fake_B_q[s:e]),
                    "D_B": d_pair("D_B", A[s:e], fake_A_q[s:e])}, None

        params_D = {**_prefixed(self.P, "D_A"), **_prefixed(self.P, "D_B")}
        d_loss, grads_D, _ = self._accumulate(A.shape[0], params_D, d_losses)
        loss.update(d_loss)
        self.opts["D"].step(params_D, grads_D, lr_of(c))
        return loss, {"G": grads_G, "D": grads_D}, {"fake_B": fake_B, "fake_A": fake_A}


def _prefixed(P: Dict[str, Dict[str, torch.Tensor]], net: str) -> Dict[str, torch.Tensor]:
    return {f"{net}.{k}": v for k, v in P[net].items()}


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """Round ``t`` through float8 e4m3 with a per-tensor scale (its largest
    magnitude to 448), straight through for gradients: the reference one
    precision below bf16."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach())


def split_net(name: str) -> Tuple[str, str]:
    net, _, leaf = name.partition(".")
    return net, leaf
