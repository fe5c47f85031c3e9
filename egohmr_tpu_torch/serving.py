"""Serving wrapper for stage-2 body sampling (port of
egohmr_tpu/serving.py:Predictor).

  * one fixed (batch_size, num_samples) shape: short requests are padded
    and the results trimmed;
  * bf16 parameters are cast once, at startup;
  * on the card (`captured`) a NumPy request is uploaded through a
    resident staging ring per replica (`data/staging.py`): one copy of each
    leaf into a pinned host slot, the transfer on a copy stream into one of
    two device slots, which request i+1's transfer fills while request i
    replays; the request's stream waits for its transfer. `staged`,
    `unstaged` (the requests that took `to_torch`: on the CPU, under tp >
    1, with tensor leaves, `eager`) and `slot_waits` count them;
  * all selected outputs are packed into ONE [B, S, sum(D)] tensor in
    sorted key order and copied to the host once, into pinned memory;
  * `map_batches` keeps a bounded window of requests in flight: PyTorch
    queues work asynchronously, so the host prepares and submits request
    i+1 while the card still runs request i, and waits only on the readback
    event of the oldest request;
  * `device` may be a sequence of devices, the counterpart of the JAX
    package's 1-D `mesh=`: one replica per entry, each request's batch
    split into equal blocks of rows, one per replica; or a data x model
    grid of devices, the counterpart of its 2-D `mesh=`: one replica per
    row, its scene PointNet and GCN split over the row's devices
    (`parallel/tp.py`);
  * on the card the request is ONE captured program per shape, as the JAX
    package's `jax.jit(_run)` is one compiled program: conditioning, the
    whole sampling loop (guided steps and their autograd pass included),
    SMPL, the reprojection and the packing, captured once as a CUDA graph
    and replayed (`utils/graphs.py`). x_T and the steps' noise are drawn
    from the request's seeded generator outside the graph and copied in;
  * under a `torch.profiler` session a request's host steps are spans
    (`utils/profiling.py:span`, all with the request's number):
    `serve.submit` over `serve.upload` (over `serve.stage_wait` where the
    host waits for a staging slot), `serve.launch` and `serve.readback`,
    and `serve.result` over `serve.wait` and `serve.unpack`. On the card
    its phases are marked (`utils/profiling.py:mark`), the last, `end`,
    after the packing.
"""
from __future__ import annotations

import copy
import functools
import itertools
import weakref
from collections import deque
from dataclasses import replace
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .data import pad_batch, to_torch
from .data.staging import Staged, Staging, numpy_leaves
from .collision.neural_occupancy import PartFieldNet
from .diffusion import DiffusionSchedule, GuidanceConfig, draw_step_noise
from .eval.pipeline import sample_bodies
from .models import BodyRepStats, EgoHMR, EgoHMRConfig
from .nn import cast_params_bf16
from .parallel.mesh import shard_batch
from .parallel.tp import egohmr_tp_specs, place_params
from .smpl import SMPLModel
from .utils.graphs import CapturedProgram
from .utils.profiling import mark, span

# the compact default output set; pose/betas (+ the input translation)
# determine the body, the mesh costs ~5 MB per batch of readback
_OUTPUT_KEYS = (
    "pred_pose_6d", "pred_betas", "pred_keypoints_3d",
    "pred_keypoints_3d_full", "pred_keypoints_2d_full",
)
MESH_OUTPUT_KEYS = _OUTPUT_KEYS + ("pred_vertices",)
# the output key of the guided steps' record (`record_guidance`)
GUIDANCE_RECORD = "guidance_record"


class Pending(NamedTuple):
    """A submitted request: its host buffer, the event that marks the
    readback done (None on the CPU), its number of valid rows, and its
    number among the Predictor's requests (its spans' `request`)."""

    host: torch.Tensor
    done: Optional[torch.cuda.Event]
    n: int
    request: Optional[int] = None


class Predictor:
    """Fixed-shape, pipelined stage-2 sampler for serving on `device`.

    Every request runs the whole pipeline: conditioning once per image
    (ResNet + the scene PointNet + heads), `num_samples` bodies per image
    through `sampler` ("ddim" or "ddpm") over `schedule`, with the
    collision-score guidance when `with_guidance`, SMPL skinning and
    reprojection. `pointnet_impl` overrides
    `cfg.pointnet_impl`: the scene encoder is kernel K1 by default
    ("fused"), or plain torch matmuls ("xla").

    The guidance's gradient comes from `collision_backend`: the mesh SDF
    ("sdf", kernel K2), or the learned part-wise occupancy ("occupancy") or
    signed-distance ("volsdf", EgoHMR-VolSMPL's) net `collision_net` (a
    `PartFieldNet`; each replica gets a copy on its device), which runs in
    float32 on the bf16 path too, its matmuls as the process's settings
    have them (TF32 off by default), over the scene in chunks of points.
    `guidance_scene_points` caps the scene points the guidance reads (the
    top-K nearest the canonical origin; None: the whole cloud).
    `record_guidance` (guided DDPM) returns, with the outputs, each guided
    step's terms under "guidance_record" ([n, S, G, 4, 144] f32: x_t, the
    posterior mean, the gradient, the step's output; `sample_loop`'s
    `guidance_record`).
    `guided_steps` and `field_rows` count the guidance's work, replays
    included.

    `device` may be a sequence of devices (the JAX package's 1-D `mesh=`):
    `batch_size` must divide by its length; each entry holds a replica
    (cast to bf16 once, at load), and each request's rows are split into
    equal blocks, one per replica, launched in turn from the host thread.
    A request's x_T is drawn from its seeded generator for the whole batch
    on the first device and each block copied to its replica; the step
    noise is drawn for the whole batch too and each replica keeps its rows,
    and the guidance's batch mean runs over the whole batch, so the
    outputs are those of one device. They are assembled on the first
    device in row order. Two entries may name the same card; each is then
    a replica of its own.

    `device` may also be a dp x tp grid, a sequence of dp rows of tp
    devices (`parallel.make_dp_tp_grid`; the JAX package's 2-D data x model
    `mesh=`): each row is a data block, as each replica above, and holds a
    copy of the model placed over its devices (`parallel.place_params`
    with `egohmr_tp_specs`): the scene PointNet and the GCN run split, the
    rest on the row's first device. `batch_size` must divide by dp and
    every split width by tp. Under tp > 1 the scene encoder is the split
    plain one: `pointnet_impl="fused"` becomes "xla" (kernel K1 is one
    device's program, as the JAX package's `pallas_call`, which GSPMD
    cannot partition), which `self.cfg.pointnet_impl` shows. A dp x 1 grid
    is the flat sequence of its rows' devices.

    `captured` says which path a request takes. True on CUDA devices
    without a model split (one device, or a flat sequence): each replica's
    request (`_sample` + `_pack`, the JAX package's `_run`) is a
    `CapturedProgram`, captured as a CUDA graph on the first request of a
    shape (or by `warmup`) and replayed from then on; the outputs equal the
    eager request's. A request whose leaves are all NumPy arrays is then
    uploaded through each replica's staging ring (`data/staging.py`),
    built for the batch's signature when it is first seen, and counted in
    `staged`; any other request takes `to_torch` and counts in
    `unstaged`. False on the CPU, where the request runs eagerly, and
    under tp > 1: a grid's request spans several devices, and a graph is
    one device's, so the grid stays eager (the JAX package's 2-D mesh is
    one GSPMD program; the port has no counterpart of that yet)."""

    def __init__(
        self,
        model: EgoHMR,
        cfg: EgoHMRConfig,
        smpl: SMPLModel,
        stats: BodyRepStats,
        schedule: DiffusionSchedule,
        *,
        device: Union[torch.device, str, Sequence[Union[torch.device, str]]],
        batch_size: int = 64,
        num_samples: int = 1,
        bf16: bool = True,
        max_inflight: int = 4,
        output_keys=_OUTPUT_KEYS,
        pointnet_impl: str = "fused",
        pack_dtype: torch.dtype = torch.float32,
        sampler: str = "ddim",
        with_guidance: bool = False,
        guidance: GuidanceConfig = GuidanceConfig(),
        collision_backend: str = "sdf",
        collision_net: Optional[PartFieldNet] = None,
        guidance_scene_points: Optional[int] = 4096,
        record_guidance: bool = False,
    ):
        entries = list(device) if isinstance(device, (list, tuple)) else [device]
        if not entries:
            raise ValueError("Predictor needs at least one device")
        nested = [isinstance(d, (list, tuple)) for d in entries]
        if any(nested) and not all(nested):
            raise ValueError("a device grid's entries must all be rows of devices")
        self.grid = [[torch.device(d) for d in (e if n else [e])]
                     for e, n in zip(entries, nested)]
        self.tp = len(self.grid[0])
        if self.tp == 0 or any(len(r) != self.tp for r in self.grid):
            raise ValueError("a device grid's rows must be of one non-zero width: "
                             f"{[len(r) for r in self.grid]}")
        if self.tp > 1 and pointnet_impl == "fused":
            pointnet_impl = "xla"  # K1 runs on one device; the split encoder is the plain one
        self.cfg = replace(cfg, pointnet_impl=pointnet_impl)
        self.devices = [r[0] for r in self.grid]  # each data block's first device
        self.device = self.devices[0]
        self.batch_size = int(batch_size)
        if self.batch_size % len(self.devices):
            what = "data rows" if self.tp > 1 else "devices"
            raise ValueError(f"batch_size {self.batch_size} must divide by the "
                             f"{len(self.devices)} {what}")
        if len({d.type for r in self.grid for d in r}) > 1:
            raise ValueError("the devices of one Predictor must be of one type: "
                             f"{[[str(d) for d in r] for r in self.grid]}")
        self.num_samples = int(num_samples)
        self.bf16 = bf16
        self.max_inflight = max(1, int(max_inflight))
        self.pack_dtype = pack_dtype
        self.sampler = sampler
        self.with_guidance = with_guidance
        self.guidance = guidance
        if collision_backend not in ("sdf", "occupancy", "volsdf"):
            raise ValueError(f"unknown collision_backend: {collision_backend}")
        if collision_backend == "sdf" and collision_net is not None:
            raise ValueError("collision_net is the learned backends' net; the mesh SDF "
                             "(collision_backend 'sdf') takes none")
        if with_guidance and collision_backend != "sdf" and collision_net is None:
            raise ValueError(f"collision_backend {collision_backend!r} needs a learned "
                             "collision net (collision_net)")
        if record_guidance and not (with_guidance and sampler == "ddpm"):
            raise ValueError("record_guidance records the guided DDPM steps: it needs "
                             "with_guidance and sampler 'ddpm'")
        if record_guidance and pack_dtype != torch.float32:
            raise ValueError("the guidance record is read back in float32: it needs "
                             "pack_dtype torch.float32")
        self.collision_backend = collision_backend
        self.guidance_scene_points = guidance_scene_points
        self.record_guidance = record_guidance
        self._output_keys = tuple(output_keys) + (
            (GUIDANCE_RECORD,) if record_guidance else ())
        if bf16:
            model = cast_params_bf16(model)
        # per data block: its model and, under tp > 1, its placement
        if self.tp > 1:
            model = model.to(memory_format=torch.channels_last).eval()
            blocks = [(p.module, p) for p in
                      place_params(self.grid, model, egohmr_tp_specs(model))]
        else:
            blocks = [((model if i == 0 else copy.deepcopy(model)).to(
                d, memory_format=torch.channels_last).eval(), None)
                for i, d in enumerate(self.devices)]
        self._replicas = [
            (rep, smpl.to(d), BodyRepStats(stats.mean.to(d), stats.std.to(d)),
             schedule.to(d), placed)
            for d, (rep, placed) in zip(self.devices, blocks)]
        # the learned collision net in f32 on each data block's first device;
        # the guidance differentiates w.r.t. x_t alone
        self._collision_nets = [
            None if collision_net is None else
            (collision_net if i == 0 else copy.deepcopy(collision_net)).to(d).eval()
            .requires_grad_(False)
            for i, d in enumerate(self.devices)]
        self._layout = None  # [(key, trailing_shape, offset, size)]
        self._requests = itertools.count()  # each request's number, for its spans
        self.captured = self.tp == 1 and self.device.type == "cuda"
        n = len(self.devices)
        self.staged = 0  # requests uploaded through the staging rings
        self.unstaged = 0  # requests that took `to_torch`
        # the guidance's work, counted where it runs (a replay counts too):
        # guided steps, and the (body, part, scene point) rows the learned
        # field evaluates over them (0 for the mesh SDF)
        self.guided_steps = 0
        self.field_rows = 0
        # each replica's block of a request, staged on its device. Request j
        # writes the host slot of request j - depth once that slot's
        # transfer is done. The transfer starts when request j - depth - 2
        # has read its device slot and runs beside the replay of request
        # j - depth - 1; `map_batches` submits j once request
        # j - max_inflight is done. So depth max_inflight - 1 finds the
        # transfer done; two keep a slot for the host to write while the
        # other's transfer runs
        depth = max(2, self.max_inflight - 1)
        self._staging = [Staging(d, self.batch_size // n, depth)
                         for d in self.devices] if self.captured else []
        # the programs hold a weak reference: no cycle keeps a dropped
        # Predictor's graphs and pools for the collector to free later,
        # perhaps in the middle of another program's capture
        me = weakref.proxy(self)
        self._programs = [
            CapturedProgram(functools.partial(Predictor._request, me, replica, (i, n)),
                            name=f"Predictor request (replica {i} of {n})")
            for i, replica in enumerate(self._replicas)]

    def _pack(self, outs: Dict) -> torch.Tensor:
        missing = [k for k in self._output_keys if k not in outs]
        if missing:
            raise ValueError(f"output_keys {missing} not produced by the "
                             f"pipeline; available: {sorted(outs)}")
        keys = sorted(self._output_keys)
        if self._layout is None:
            layout, off = [], 0
            for k in keys:
                trail = tuple(outs[k].shape[2:])
                size = int(np.prod(trail)) if trail else 1
                layout.append((k, trail, off, size))
                off += size
            self._layout = layout
        flat = [outs[k].to(self.pack_dtype).reshape(
            outs[k].shape[0], self.num_samples, -1) for k in keys]
        return torch.cat(flat, dim=-1)

    def _sample(self, replica, net: Optional[PartFieldNet], batch: Dict,
                generator: torch.Generator, **kw) -> Dict:
        model, smpl, stats, schedule, placed = replica
        outs, _ = sample_bodies(
            model, self.cfg, smpl, stats, schedule,
            batch, generator, self.num_samples, sampler=self.sampler,
            with_guidance=self.with_guidance, guidance=self.guidance,
            collision_backend=self.collision_backend, occ_net=net,
            guidance_scene_points=self.guidance_scene_points,
            record_guidance=self.record_guidance, counter=self,
            tp=placed, **kw)
        return outs

    def _request(self, replica, shard, batch: Dict, x_T: torch.Tensor,
                 step_noise: torch.Tensor) -> torch.Tensor:
        """One replica's request, the program that is captured: the block
        `shard` of the batch from x_T and the steps' noise to the packed
        outputs. It draws nothing."""
        net = self._collision_nets[shard[0]]
        packed = self._pack(self._sample(replica, net, batch, None, noise=x_T,
                                         step_noise=step_noise, shard=shard))
        mark("end", packed)
        return packed

    @property
    def slot_waits(self) -> int:
        """Uploads that waited for a staging slot's transfer to finish."""
        return sum(s.waits for s in self._staging)

    def _stage(self, batch: Dict, n: int) -> Optional[List[Staged]]:
        """Each replica's block of a NumPy batch of `n` rows, padded to
        `batch_size`, staged on its device; None where the batch is not all
        NumPy (`numpy_leaves`)."""
        leaves = numpy_leaves(batch, n)
        if leaves is None:
            return None
        return [s.upload(leaves, i * s.rows, n) for i, s in enumerate(self._staging)]

    def _run(self, batch: Dict, generator: torch.Generator, *,
             eager: bool = False, staged: Optional[List[Staged]] = None) -> torch.Tensor:
        n = len(self.devices)
        rows = self.batch_size * self.num_samples
        x_T = torch.randn((rows, 144), generator=generator, device=self.device)
        state = generator.get_state()
        parts = []
        for i, (d, replica, program) in enumerate(zip(self.devices, self._replicas,
                                                      self._programs)):
            # each replica draws the whole batch's step noise from the state
            # after x_T and keeps its rows, as one device would draw it
            g = torch.Generator(device=d)
            g.set_state(state)
            step_noise = draw_step_noise(replica[3], g, (rows // n, 144), sampler=self.sampler,
                                         shard=(i, n))
            run = program if self.captured and not eager else program.eager
            x_block = shard_batch((i, n), x_T).to(d)
            if staged is None:
                parts.append(run(to_torch(shard_batch((i, n), batch), d), x_block, step_noise))
            else:
                stream = torch.cuda.current_stream(d)
                stream.wait_event(staged[i].ready)
                parts.append(run(staged[i].batch, x_block, step_noise))
                staged[i].consumed.record(stream)  # the program has copied the slot in
        if n == 1:
            return parts[0]
        return torch.cat([p.to(self.device) for p in parts])

    def submit(self, batch: Dict, *, seed: int = 0) -> Pending:
        """Queue one request (asynchronous on the card). On the card a
        request of a shape not seen before captures its program first."""
        return self._submit(batch, seed, eager=False)

    def eager(self, batch: Dict, *, seed: int = 0) -> Dict[str, np.ndarray]:
        """One blocking request run eagerly, without the captured program:
        what a replayed request must equal, and the run in which a caller
        can watch every kernel call. For comparisons, not for serving."""
        return self.result(self._submit(batch, seed, eager=True))

    def _submit(self, batch: Dict, seed: int, eager: bool) -> Pending:
        n = batch["img"].shape[0]
        if n > self.batch_size:
            raise ValueError(
                f"request batch {n} > compiled batch {self.batch_size}; "
                "split upstream or build a bigger Predictor")
        request = next(self._requests)
        with span("serve.submit", request):
            with span("serve.upload"):
                staged = self._stage(batch, n) if self.captured and not eager else None
                if staged is None:
                    self.unstaged += 1
                    batch = to_torch(batch, self.device)
                    if n < self.batch_size:
                        batch = pad_batch(batch, self.batch_size)
                else:
                    self.staged += 1
            with span("serve.launch"):
                generator = torch.Generator(device=self.device).manual_seed(seed)
                packed = self._run(batch, generator, eager=eager, staged=staged)
            with span("serve.readback"):
                cuda = self.device.type == "cuda"
                # a fresh host buffer, its copy queued before the next
                # request's replay overwrites the program's output
                host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=cuda)
                host.copy_(packed, non_blocking=cuda)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
        return Pending(host, done, n, request)

    def result(self, pending: Pending) -> Dict[str, np.ndarray]:
        """Wait for a submitted request; numpy outputs [n, S, ...] f32."""
        with span("serve.result", pending.request):
            with span("serve.wait"):
                if pending.done is not None:
                    pending.done.synchronize()
            with span("serve.unpack"):
                host = pending.host.float().numpy()
                out = {}
                for k, trail, off, size in self._layout:
                    v = host[:pending.n, :, off:off + size]
                    out[k] = np.array(v.reshape((pending.n, self.num_samples) + trail))
        return out

    def __call__(self, batch: Dict, *, seed: int = 0) -> Dict[str, np.ndarray]:
        """One blocking request."""
        return self.result(self.submit(batch, seed=seed))

    def warmup(self, batch: Optional[Dict] = None) -> None:
        """Run one request before taking traffic, and wait for it: the
        kernels are built, cuDNN picks its algorithms and the allocator
        grows to the request's size; on the card (`captured`) the request's
        program is captured for the batch's shapes, as the JAX package's
        `warmup` compiles.

        `batch` must have the shapes real traffic will use (image size,
        scene-point count): what is warmed is warmed per shape."""
        if batch is None:
            raise ValueError(
                "warmup() needs a representative batch: cuDNN's algorithms "
                "and the allocator's pools are chosen PER SHAPE. Pass a "
                "batch with real traffic's image size and scene-point "
                "count, e.g. egohmr_tpu_torch.data.synthetic_batch("
                f"{self.batch_size}, num_scene_points=<your P>)")
        self.result(self.submit(batch))

    def map_batches(self, batches: Iterable[Dict], *,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Run a stream of requests with at most `max_inflight` in flight;
        yields outputs in input order (request i uses seed + i)."""
        window: deque = deque()
        for i, b in enumerate(batches):
            window.append(self.submit(b, seed=seed + i))
            if len(window) >= self.max_inflight:
                yield self.result(window.popleft())
        while window:
            yield self.result(window.popleft())
