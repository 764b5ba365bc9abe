"""Rank programs that hold the spatially sharded and the data-parallel
paths to what they must equal, for ``parallel.mesh.spawn``. The CPU tests
spawn them (their ranks import torch and the port only, never JAX) and
``chip_smoke.py`` runs them on the card. Each is ``fn(rank, n, device, say, *args)`` with numpy in and out;
rank 0's return value is the result. Beside them, ``LoopbackRing`` runs the
halo kernel's signalled exchange among the peers of a ring inside one
process on one card, and ``ring_halos`` gives the halos a ring must bring.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from biasgan_tpu_torch.kernels import launch_counts, zero_counts
from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused_t
from biasgan_tpu_torch.kernels.halo_exchange import (
    SignalSeq,
    Slabs,
    alloc_slab,
    free_slab,
    signal_recv,
    signal_send,
)
from biasgan_tpu_torch.parallel.mesh import RankCtx
from biasgan_tpu_torch.parallel.spatial import HaloCtx, shard_w, spatial_apply


def _gathered(ctx: HaloCtx, t: torch.Tensor) -> Optional[np.ndarray]:
    """The W shards of ``t`` concatenated on rank 0, as numpy (None on the
    other ranks)."""
    y = ctx.gather_w(t.detach())
    return None if y is None else y.float().cpu().numpy()


def kernel_counts() -> Dict[str, int]:
    """This process's kernel launches, with the differentiable block
    conv's (``conv3x3_fused_t``)."""
    return {**launch_counts(), "conv3x3_fused_t": conv3x3_fused_t.launches}


def _zero_counts() -> None:
    zero_counts()
    conv3x3_fused_t.launches = 0


def halo_cases(rank, n, device, say, x: np.ndarray, cases: Sequence[Tuple[int, int, bool]]):
    """For each ``(left, right, periodic)`` and each transport (the plain
    ring; ``rdma``: the ``halo_exchange_w`` wrapper), this rank's W shard of
    the global NHWC ``x`` through ``HaloCtx.pad_w``, the padded shards
    concatenated along W on rank 0: ``{(left, right, periodic, rdma):
    array}``. Under ``"guard"``, the message of the ValueError that a halo
    one column wider than the shard raises."""
    xt = torch.from_numpy(x).to(device)
    out: Dict = {}
    with torch.inference_mode():
        for left, right, periodic in cases:
            for rdma in (False, True):
                ctx = HaloCtx(n, periodic, rdma)
                y = ctx.gather_w(ctx.pad_w(shard_w(xt, ctx), left, right))
                ctx.close()
                if rank == 0:
                    out[(left, right, periodic, rdma)] = y.cpu().numpy()
        ctx = HaloCtx(n, True, True)
        xl = shard_w(xt, ctx)
        try:
            ctx.pad_w(xl, xl.shape[2] + 1, 0)
        except ValueError as e:
            out["guard"] = str(e)
    return out


def ring_halos(xs: Sequence[torch.Tensor], left: int, right: int,
               periodic: bool) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The (left, right) halos of each shard ``xs[p]`` of a ring: the last
    ``left`` columns of its left neighbour's shard and the first ``right``
    of its right neighbour's, zeros across a non-periodic global edge."""
    peers, out = len(xs), []
    for p in range(peers):
        lh = xs[p - 1][:, :, xs[p - 1].shape[2] - left:]
        rh = xs[(p + 1) % peers][:, :, :right]
        if not periodic and p == 0:
            lh = torch.zeros_like(lh)
        if not periodic and p == peers - 1:
            rh = torch.zeros_like(rh)
        out.append((lh.contiguous(), rh.contiguous()))
    return out


class LoopbackRing:
    """A ring of ``peers`` peers inside this process, all on ``device``:
    each peer has its own receive slab of ``cap``-byte buffers, its own
    CUDA stream and its own ``SignalSeq``, and addresses its neighbours'
    slabs directly. Its exchanges are the signalled route's
    (``signal_send``, ``signal_recv``), the peers' kernels co-resident on
    the card: the protocol held on one card. Every peer's sends of an
    exchange are launched before any of its receives, so a kernel only
    ever waits on kernels launched before it, however the card queues the
    streams."""

    def __init__(self, peers: int, periodic: bool, cap: int, device: torch.device):
        self.periodic, self.cap, self.device = periodic, cap, device
        self.bases = [alloc_slab(device, cap)[0] for _ in range(peers)]
        self.streams = [torch.cuda.Stream(device) for _ in range(peers)]
        self.seqs = [SignalSeq() for _ in range(peers)]

    def slabs(self, p: int) -> Slabs:
        b = self.bases
        return Slabs(b[p], b[p - 1], b[(p + 1) % len(b)], self.cap)

    def run(self, rounds: Sequence[Sequence[torch.Tensor]], left: int, right: int
            ) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Back-to-back exchanges, one per round of ``rounds`` (each
        round: every peer's NHWC shard, made on the current stream, of
        one shape for all), no peer waiting on the host; returns each
        round's (left, right) halos per peer, ready on the current
        stream."""
        main = torch.cuda.current_stream(self.device)
        peers = len(self.bases)
        for s in self.streams:
            s.wait_stream(main)
        out = []
        for xs in rounds:
            n, h, _, c = xs[0].shape
            halos = []
            for s in self.streams:
                with torch.cuda.stream(s):
                    halos.append((xs[0].new_empty((n, h, left, c)),
                                  xs[0].new_empty((n, h, right, c))))
            es = xs[0].element_size()
            steps = [seq.next(n * h * left * c * es, n * h * right * c * es)
                     for seq in self.seqs]
            edge = not self.periodic
            for p in range(peers):
                signal_send(xs[p], left, right, steps[p], self.slabs(p),
                            edge and p == peers - 1, edge and p == 0, self.streams[p])
            for p in range(peers):
                signal_recv(*halos[p], steps[p], self.slabs(p), self.streams[p])
            out.append(halos)
        for s in self.streams:
            main.wait_stream(s)
        for halos in out:
            for lh, rh in halos:
                lh.record_stream(main)
                rh.record_stream(main)
        return out

    def close(self) -> None:
        torch.cuda.synchronize(self.device)
        for base in self.bases:
            free_slab(self.device, base)
        self.bases = []


def generator_cases(rank, n, device, say, spec: dict, state: Dict[str, np.ndarray],
                    x: np.ndarray, cases: Sequence[dict]):
    """For each case ``{"w_mode": 'wrap' | 'zero', "fused": bool, "rdma":
    bool}``: ``define_G(**spec, w_mode=..., fused_blocks=...)`` with the
    weights ``state``, in eval mode on ``device``, through ``spatial_apply``
    on the global NHWC ``x``. Returns ``{"outputs": [rank 0's gathered
    output per case], "launches": [each rank's kernel launches]}``."""
    from biasgan_tpu_torch.nn import define_G

    xt = torch.from_numpy(x).to(device)
    outputs: List = []
    with torch.inference_mode():
        for case in cases:
            G = define_G(**spec, w_mode=case["w_mode"], fused_blocks=case["fused"])
            G.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
            G = G.to(device).eval()
            ctx = HaloCtx(n, case["w_mode"] == "wrap", case["rdma"])
            y = spatial_apply(G, ctx)(xt)
            ctx.close()
            outputs.append(None if y is None else y.cpu().numpy())
    launches = [None] * n
    dist.all_gather_object(launches, launch_counts())
    return {"outputs": outputs, "launches": launches}


def adjoint_cases(rank, n, device, say, x: np.ndarray, cots: Dict, cases: Sequence):
    """The gradients of ``HaloCtx``'s differentiable collectives on the
    global NHWC ``x`` (each rank its W shard), with every rank's loss the
    sum of its output times its cotangent in ``cots`` (rank-major arrays).
    For each case ``("ring", left, right, periodic)``, ``("sum", )`` (the
    instance norms' and moments' ``all_reduce``) or ``("gather", )``
    (``all_gather_w``): the shards' gradients concatenated along W on rank
    0. Their sum over the ranks is the gradient of the sum of the ranks'
    losses, which the whole field's autograd gives."""
    xt = torch.from_numpy(x).to(device)
    out = {}
    for case in cases:
        ctx = HaloCtx(n, periodic=case[3] if case[0] == "ring" else True)
        xl = shard_w(xt, ctx).requires_grad_(True)
        if case[0] == "ring":
            y = ctx.pad_w(xl, case[1], case[2])
        elif case[0] == "sum":
            y = ctx.sum_w(xl)
        else:
            y = ctx.all_gather_w(xl)
        c = torch.from_numpy(cots[case][rank]).to(device)
        (y * c).sum().backward()
        out[case] = _gathered(ctx, xl.grad)
        ctx.close()
    return out


def generator_grad_cases(rank, n, device, say, spec: dict, state: Dict[str, np.ndarray],
                         x: np.ndarray, gy: np.ndarray, cases: Sequence[dict]):
    """For each case ``{"w_mode", "fused"}``: ``define_G(**spec, ...)`` with
    the weights ``state``, in train mode, on this rank's W shard of the
    global NHWC ``x``, and the loss ``sum(G(x) * gy)`` over the shard. The
    gradients summed over the ranks (the whole field's, as the JAX
    ``spatial_apply`` under ``jax.grad`` gives them) and the input's,
    gathered along W: ``[{"loss", "grads": {name: array}, "dx"}]`` on rank
    0, with each rank's kernel launches."""
    from biasgan_tpu_torch.nn import define_G

    xt, gyt = (torch.from_numpy(a).to(device) for a in (x, gy))
    out = []
    for case in cases:
        G = define_G(**spec, w_mode=case["w_mode"], fused_blocks=case["fused"])
        G.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        G = G.to(device).train()
        ctx = HaloCtx(n, case["w_mode"] == "wrap")
        xl = shard_w(xt, ctx).requires_grad_(True)
        loss = (G(xl, ctx=ctx) * shard_w(gyt, ctx)).sum()
        loss.backward()
        params = list(G.parameters())
        ctx.mean_grads_(params)
        res = {"loss": float(ctx.sum_w(loss.detach())),
               "grads": {k: p.grad.cpu().numpy() * n for k, p in G.named_parameters()},
               "dx": _gathered(ctx, xl.grad)}
        ctx.close()
        out.append(res)
    launches = [None] * n
    dist.all_gather_object(launches, kernel_counts())
    return {"cases": out, "launches": launches}


def train_cases(rank, n, device, say, argv: Sequence[str], cases: Sequence[dict],
                nets: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
                batches: Optional[Sequence[Dict[str, np.ndarray]]] = None):
    """Sharded training steps (pix2pix or CycleGAN, as --model says), one
    rank of ``n``: for each case ``{"flags": [...], "steps": k}`` (and
    optionally ``"grads": path``, ``"gp_alpha"``, ``"fakes"``), the training
    config of ``argv`` + flags and its contexts (``train.rank_contexts``: W
    shards over the ``n`` ranks, or with --data_mesh D --spatial_mesh S the
    2-D mesh), the state from the weights ``nets`` (net -> state dict; else
    seeded from --seed, as ``create_state`` draws it), ``k`` steps on
    ``batches`` (the global batches, each data rank stepping on its slice;
    else the dataset's first ``k``) with the step generators of (--seed,
    step), as the training loop draws them. Per case on rank 0: each step's
    losses (pix2pix with its g_grad_norm and d_grad_norm); each rank's
    kernel launches over the steps (counted from 0); whether every rank's
    parameters are bitwise rank 0's (the pools every data rank's); where
    ``nets`` is given or the case says ``"state": True``, the nets' state
    dicts and the replay pools (gathered on W) after the steps.
    ``"gp_alpha"``: per step, per data rank, pix2pix wgangp's alpha. ``"fakes"``: the last step's fake_B, gathered over W
    and the data ranks. ``"perturb"``: the first global batch's A and B
    moved by that relative noise (a noise floor). With ``"grads"``, rank 0
    saves step 1's mean G and D gradients there (``torch.save``; CycleGAN's
    from the step, pix2pix's from Adam's first moment, (1 - b1) g after one
    step). Under --steps_per_call K (in the flags) the steps run as calls
    of ``make_scan_step``, K batches stacked a call (a ragged tail of
    ``steps`` is not run); each step's losses are read after its call."""
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.data import create_dataset
    from biasgan_tpu_torch.models.common import make_scan_step, step_generator
    from biasgan_tpu_torch.registry import get_model
    from biasgan_tpu_torch.train import batch_to, params_equal_across_ranks, rank_contexts

    out = []
    for case in cases:
        cfg = parse_config(list(argv) + list(case["flags"]), train=True)
        model = get_model(cfg.model)
        steps = case["steps"]
        ctx, data = rank_contexts(cfg, n)
        if batches is None:
            loader = create_dataset(cfg)
            cfg.steps_per_epoch = len(loader)
            run = [batch_to(d, device) for _, d in zip(range(steps), loader)]
        else:
            cfg.steps_per_epoch = max(cfg.steps_per_epoch, len(batches))
            run = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                   for b in batches[:steps]]
        if case.get("perturb"):
            g = torch.Generator().manual_seed(11)
            run[0] = {k: v * (1 + case["perturb"] * torch.randn(v.shape, generator=g).to(device))
                      if k in ("A", "B") else v for k, v in run[0].items()}
        if data is not None:
            run = [{k: data.rank_slice(v) for k, v in b.items()} for b in run]
        state = model.create_state(cfg, device, ctx=ctx)
        if nets is not None:
            for name, net in state.nets.items():
                net.load_state_dict({k: torch.from_numpy(v) for k, v in nets[name].items()})
        debug = ({"debug_grads": bool(case.get("grads"))} if cfg.model == "cycle_gan"
                 else {"debug_grad_norms": True})
        step = model.make_train_step(cfg, ctx=ctx, data=data, **debug)
        _zero_counts()
        losses, grads = [], None
        spc = max(cfg.steps_per_call, 1)
        if spc > 1:  # K-step calls on the stacked batches, as the training loop makes them
            call = make_scan_step(step, spc, cfg.seed)
            for c in range(len(run) // spc):
                group = run[c * spc:(c + 1) * spc]
                ls, vis = call(state, {k: torch.stack([b[k] for b in group]) for k in group[0]},
                               c * spc)
                losses += [{k: float(v[i]) for k, v in ls.items()} for i in range(spc)]
            run = []
        for i, batch in enumerate(run):
            kw = {}
            if case.get("gp_alpha") is not None:
                kw["gp_alpha"] = torch.from_numpy(
                    case["gp_alpha"][i][0 if data is None else data.rank]).to(device)
            ls, vis = step(state, batch, step_generator(cfg.seed, i), **kw)
            losses.append({k: float(v) for k, v in ls.items()})
            if i == 0 and case.get("grads"):
                grads = ({w: {k: v.cpu() for k, v in vis[f"_{w.lower()}_grads"].items()}
                          for w in ("G", "D")} if cfg.model == "cycle_gan" else
                         {w: {k: (t / (1 - o.b1)).cpu() for k, t in o.mu.items()}
                          for w, o in state.opts.items()})
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = [None] * n
        dist.all_gather_object(launches, kernel_counts())
        res = {"losses": losses, "launches": launches, "step": state.step,
               "params_equal": params_equal_across_ranks(state, RankCtx(n), pools=data)}
        if nets is not None or case.get("state"):  # the state after, where it is small
            res["pools"] = {k: _gathered(ctx, p.buffer) for k, p in state.pools.items()}
            res["nets"] = {k: {name: t.detach().cpu().numpy()
                               for name, t in v.state_dict().items()}
                           for k, v in state.nets.items()}
        if case.get("fakes"):
            fake = vis["fake_B"].detach().float()
            fake = fake if ctx is None else ctx.all_gather_w(fake)
            fake = fake if data is None else data.all_gather_batch(fake)
            res["fakes"] = fake.cpu().numpy()
        if grads is not None and rank == 0:
            torch.save(grads, case["grads"])
        for c in (ctx, data):
            if c is not None:
                c.close()
        del state, step, run, vis
        out.append(res)
    return out


def layout_cases(rank, n, device, say, data: int, x: np.ndarray,
                 pads: Sequence[Tuple[int, int, bool]]):
    """The 2-D mesh's groups on a ``data`` x ``n / data`` mesh
    (``mesh.mesh_groups``), one rank's view, gathered on rank 0 over the
    world: each rank's (d, s), its row's and column's world ranks; for each
    ``(left, right, periodic)`` row d's halo exchange of its W shard of
    ``x[d]`` (a global NHWC field per row), gathered on W at the row's
    rank 0; and on every row, ``same_on_every_rank`` of a tensor equal on
    the row and of one that differs on the row's last rank, and
    ``gather_w`` of ``x[d]``'s shards (None off the row's rank 0)."""
    from biasgan_tpu_torch.parallel.mesh import mesh_groups

    spatial = n // data
    data_group, spatial_group = mesh_groups(data, spatial)
    xt = torch.from_numpy(x).to(device)
    mine = {"ds": divmod(rank, spatial),
            "row": dist.get_process_group_ranks(spatial_group),
            "column": dist.get_process_group_ranks(data_group), "pads": {}}
    d = mine["ds"][0]
    for left, right, periodic in pads:
        ctx = HaloCtx(spatial, periodic, group=spatial_group)
        y = ctx.gather_w(ctx.pad_w(shard_w(xt[d], ctx), left, right))
        mine["pads"][(left, right, periodic)] = None if y is None else y.cpu().numpy()
        ctx.close()
    ctx = HaloCtx(spatial, True, group=spatial_group)
    same = torch.full((3,), float(d), device=device)
    mine["same"] = ctx.same_on_every_rank(same)
    mine["differs"] = ctx.same_on_every_rank(same + (ctx.rank == spatial - 1))
    y = ctx.gather_w(shard_w(xt[d], ctx))
    mine["gathered"] = None if y is None else y.cpu().numpy()
    ctx.close()
    every = [None] * n
    dist.all_gather_object(every, mine)
    return every


def mesh_checks(rank, n, device, say, layout: tuple, train: tuple):
    """``layout_cases(*layout)`` and ``train_cases(*train)`` in one spawn."""
    return (layout_cases(rank, n, device, say, *layout),
            train_cases(rank, n, device, say, *train))


def grad_checks(rank, n, device, say, adjoint: tuple, generator: tuple):
    """``adjoint_cases(*adjoint)`` and ``generator_grad_cases(*generator)``
    in one spawn."""
    return (adjoint_cases(rank, n, device, say, *adjoint),
            generator_grad_cases(rank, n, device, say, *generator))


def data_cases(rank, n, device, say, cases: Sequence[dict]):
    """Data-parallel steps, one rank of ``n``: for each case ``{"argv":
    [...], "batches": [global numpy batches], "gp_alpha": [per step, per
    rank (B / n, 1, 1, 1) arrays] (pix2pix wgangp, optional), "fakes":
    bool (optional)}``, the
    training config of ``argv`` (pix2pix or cycle_gan), the state seeded
    from --seed (as ``create_state`` draws it, on the CPU), one step per
    batch on this rank's slice with the step generators of (--seed, step),
    as the training loop draws them. Per case on rank 0: each step's
    losses (pix2pix with its g_grad_norm and d_grad_norm), each rank's
    kernel launches (counted from 0), whether every rank's state, the
    pools included, is bitwise rank 0's, and the nets' state dicts, Adam's
    first moments and the replay pools after the steps; with ``"grads":
    path`` in place of the last three, rank 0 saves there the gradients
    behind Adam's first moments (after one step, mu / (1 - b1): the
    averaged grads) per optimizer (``torch.save``). With ``"fakes"``, each
    rank's fake_B of the last step."""
    from biasgan_tpu_torch.config import parse_config
    from biasgan_tpu_torch.models.common import step_generator
    from biasgan_tpu_torch.parallel.data_parallel import DataCtx
    from biasgan_tpu_torch.registry import get_model
    from biasgan_tpu_torch.train import params_equal_across_ranks

    out = []
    for case in cases:
        cfg = parse_config(list(case["argv"]), train=True)
        cfg.steps_per_epoch = max(cfg.steps_per_epoch, len(case["batches"]))
        model = get_model(cfg.model)
        data = DataCtx(n)
        state = model.create_state(cfg, device)
        debug = ({"debug_grad_norms": True} if cfg.model == "pix2pix" else {})
        step = model.make_train_step(cfg, data=data, **debug)
        _zero_counts()
        losses = []
        for i, batch in enumerate(case["batches"]):
            local = {k: data.rank_slice(torch.from_numpy(v)).to(device) for k, v in batch.items()}
            kw = {}
            if case.get("gp_alpha") is not None:
                kw["gp_alpha"] = torch.from_numpy(case["gp_alpha"][i][rank]).to(device)
            ls, vis = step(state, local, step_generator(cfg.seed, i), **kw)
            losses.append({k: float(v) for k, v in ls.items()})
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = [None] * n
        dist.all_gather_object(launches, kernel_counts())
        res = {"losses": losses, "launches": launches,
               "params_equal": params_equal_across_ranks(state, data, pools=data)}
        if case.get("fakes"):
            res["fakes"] = [None] * n
            dist.all_gather_object(res["fakes"], vis["fake_B"].float().cpu().numpy())
        if case.get("grads"):
            if rank == 0:
                torch.save({k: {name: (t / (1 - o.b1)).cpu() for name, t in o.mu.items()}
                            for k, o in state.opts.items()}, case["grads"])
        else:
            res.update(
                nets={k: {name: t.detach().cpu().numpy() for name, t in v.state_dict().items()}
                      for k, v in state.nets.items()},
                mu={k: {name: t.cpu().numpy() for name, t in o.mu.items()}
                    for k, o in state.opts.items()},
                pools={k: p.buffer.cpu().numpy() for k, p in state.pools.items()})
        data.close()
        del state, step, vis
        out.append(res)
    return out
