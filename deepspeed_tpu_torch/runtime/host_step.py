"""Host-executed optimizer step with overlap (SuperOffload / ZenFlow).

Ports ``deepspeed_tpu/runtime/host_step.py`` (``HostStepRunner`` :54-241;
reference ``runtime/superoffload/superoffload_stage3.py``, the async half
of ``runtime/zenflow/zenflow_stage_1_and_2.py``) for the one-process
engine. The card holds only the compute-dtype copy, the compute-dtype
micro-batch gradient and the fp32 accumulator; the fp32 master and the
optimizer moments live in host memory from ``_init_state`` on (pageable),
and the update runs on the host's cores. One step:

1. the gas loop runs on the card into the accumulator;
2. the accumulator streams device→host into a pinned landing buffer;
3. the host update, JAX's CPU-compiled program (``_build_update``
   :160-191) as the compiled host library ``ops/cpu_adam.py``
   (``csrc/cpu_adam.cpp``): one pass divides the gradient by gas and
   gives the global norm's partials, one pass applies the clip factor and
   Adam to the master and the moments in place and writes the bf16 copy
   into a pinned staging buffer (``optimizer.host_update``), each on
   ``threads`` host threads;
4. the staging buffer streams host→device into the compute copy.

The update runs in one worker thread. The copies go on the card's
current stream, so they are ordered with the step's kernels: the
next step's ``flat_grad_acc.zero_()`` comes after the landing copy, and a
new compute copy lands after every queued kernel that reads the old one;
the host never synchronises for them. The worker waits on the landing
copy's event before it reads the landing buffer; it writes the staging
buffer only after that event, which follows the previous step's
host→device copy on the same stream.

``overlap`` (``offload_optimizer.overlap_step``; unset: ZenFlow's
``overlap_step`` when ZenFlow is on, else off), JAX's schedule exactly:
step k runs on update k-2's parameters while the host computes update
k-1, which lands after step k's gradients are enqueued — the runner waits
for update k-1 there and nowhere else, so the result does not depend on
the threads' timing. Without overlap, update k lands before step k+1.

Refused as in JAX (``host_step.py:57-72``, ``engine.py:362-364``): fp16
loss scaling, a ``pipe`` mesh axis, a state split over processes (the
update addresses this process's host memory only: JAX refuses more than
one process, each of whose devices it addresses) and the compressed
wires. Over processes that each hold the whole state — a ``seq`` axis,
whose ranks share every parameter — the data-parallel engine reduces the
gradient (its ``seq`` hop included) into its accumulator, and each rank's
runner updates its own whole copy (:meth:`HostStepRunner.step_update`).
The host library is built when the runner is made:
a missing compiler or a failed build raises ``KernelBuildError`` there,
and nothing falls back to an eager update.
"""
from __future__ import annotations

import collections
import concurrent.futures
import time
from typing import Any, Dict, List, Optional

import torch

from deepspeed_tpu_torch.accelerator import PinnedHost
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.ops import cpu_adam
from deepspeed_tpu_torch.runtime.config_utils import (
    DeepSpeedConfigError,
    logger,
)



class HostStepRunner:
    """Owns the split train step: gradients on the card, update on the
    host."""

    def __init__(self, engine):
        if engine.fp16_enabled:
            raise DeepSpeedConfigError(
                "offload_optimizer.host_step does not support fp16 loss "
                "scaling; use bf16 (the reference's SuperOffload targets "
                "bf16 too)")
        if engine.mesh_manager.pp_world_size > 1:
            raise DeepSpeedConfigError(
                "host_step is not supported with pipeline parallelism")
        mm = engine.mesh_manager
        if comm.get_world_size() > 1 and mm.axes_size(
                ("data", "zshard", "expert", "tensor")) > 1:
            raise DeepSpeedConfigError(
                "host_step is single-host for now: the update runs on this "
                "process's CPU backend and cannot address remote shards")
        self.engine = engine
        zcfg = engine.config.zero_optimization
        explicit = zcfg.offload_optimizer.overlap_step
        if explicit is not None:
            self.overlap = bool(explicit)   # the user's word is final
        else:
            self.overlap = zcfg.zenflow.enabled and zcfg.zenflow.overlap_step
        self.threads = torch.get_num_threads()
        cpu_adam.norm_block()           # builds the host library now
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dstpu-host-step",
            initializer=torch.set_num_threads, initargs=(self.threads,))
        self._pending: Optional[concurrent.futures.Future] = None
        self._pinned: List[PinnedHost] = []
        self.landing: Optional[torch.Tensor] = None
        self.staging: Optional[torch.Tensor] = None
        #: the last updates' device→host and host→device events and host
        #: seconds
        self.records = collections.deque(maxlen=64)
        logger.info(f"host-step optimizer active (overlap={self.overlap}): "
                    "fp32 master + moments on host, 16-bit params on device")

    # ------------------------------------------------------------ state
    def allocate(self, n: int) -> None:
        """The pinned buffers that cross the bus: the gradient's landing
        buffer (the accumulator's dtype) and the compute-dtype staging
        buffer. The master and the moments stay pageable."""
        e = self.engine
        self._pinned = [PinnedHost(n, e._accum_dtype(), e.device),
                        PinnedHost(n, e.compute_dtype, e.device)]
        self.landing, self.staging = (b.tensor for b in self._pinned)

    # ------------------------------------------------------------ step
    def _event(self):
        e = self.engine
        if e.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(e.device))
        return ev

    def _land(self) -> None:
        """Wait for the pending update and copy its compute-dtype params
        to the card (ordered after every queued kernel)."""
        if self._pending is None:
            return
        rec = self._pending.result()
        self._pending = None
        e = self.engine
        rec["h2d"] = (self._event(),)
        e._land_host_update(self.staging)
        rec["h2d"] += (self._event(),)

    def drain(self) -> None:
        """Land the update in flight now (before a change of schedule:
        ``overlap`` may be set after this)."""
        self._land()

    def wait(self) -> None:
        """Block until the update in flight (if any) has finished on the
        host; it is not landed on the card (the next step does that)."""
        if self._pending is not None:
            self._pending.result()

    def adopt_state(self) -> None:
        """Re-home the state after a checkpoint load (JAX
        ``host_step.py:122``): the update in flight finished and dropped
        (its staged copy holds pre-load values and must never land), the
        master and the moments kept as this process's host tensors, and
        the card's compute copy written from the restored master."""
        self.wait()
        self._pending = None
        e = self.engine
        with torch.no_grad():
            if e.flat_master.device.type != "cpu":
                e._set_master(e.flat_master.cpu())
            opt = e.state["opt"]
            for k, v in opt.items():
                if isinstance(v, torch.Tensor) and v.device.type != "cpu":
                    opt[k] = v.cpu()
            e._land_host_update(e.flat_master)

    def train_step(self, stacked, gas: int):
        """One global step; returns (mean loss, metrics). The metrics'
        ``grad_norm`` is a future the update resolves."""
        e = self.engine
        batch = e._to_device(stacked)
        e.flat_grad_acc.zero_()
        mean_loss = e.accumulate_microbatches(
            lambda mb: e._loss_and_grads(mb, None), e.flat_grad_acc,
            e.flat_grad, batch, gas)
        return mean_loss, self.step_update(float(gas))

    def step_update(self, gas_scale: float) -> Dict[str, Any]:
        """The update of a step whose gradient sum (÷ ``gas_scale`` to its
        mean) is in the engine's accumulator: landed to the host, Adam on
        the host's master, the compute copy landed on the card
        (``engine._land_host_update``) now or, under ``overlap``, after
        the next step's gradients → the metrics (``grad_norm`` a future
        the update resolves)."""
        e = self.engine
        if self.overlap:
            self._land()        # update k-1, after step k's gradients
        rec: Dict[str, Any] = {"d2h": (self._event(),)}
        self.landing.copy_(e.flat_grad_acc, non_blocking=True)
        rec["d2h"] += (self._event(),)
        lr = e._lr_at(e.state["step"])
        norm = concurrent.futures.Future()
        self.records.append(rec)
        self._pending = self._pool.submit(self._update, rec, gas_scale, lr,
                                          norm)
        if not self.overlap:
            self._land()
        e.state["step"] += 1
        return {"grad_norm": norm, "lr": lr, "overflow": 0.0}

    def _update(self, rec, gas_scale: float, lr: float, norm_out):
        """The host update of one step (the worker thread)."""
        try:
            done = rec["d2h"][1]
            if done is not None:
                done.synchronize()
            t0 = time.perf_counter()
            e = self.engine
            g = self.landing if self.landing.dtype == torch.float32 \
                else self.landing.float()
            sum_sq, _ = cpu_adam.grad_prep(g, gas_scale, self.threads)
            t1 = time.perf_counter()
            norm = cpu_adam.global_norm(sum_sq)
            norm_out.set_result(norm)
            clip = e.config.gradient_clipping
            e.optimizer.host_update(
                g, e.state["opt"], e.flat_master, lr=lr, out=self.staging,
                clip=cpu_adam.clip_factor(norm, clip) if clip > 0 else None,
                threads=self.threads)
            t2 = time.perf_counter()
            rec.update(host_update_s=t2 - t0, host_prep_s=t1 - t0,
                       host_adam_s=t2 - t1, threads=self.threads)
            return rec
        except BaseException as exc:
            if not norm_out.done():
                norm_out.set_exception(exc)
            raise

    def stats(self) -> List[Dict[str, float]]:
        """Per finished update: device→host and host→device ms (CUDA
        events; None on the CPU), the host update's seconds (and its two
        passes') and its threads."""
        self.wait()
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        out = []
        for rec in self.records:
            row = {k: rec.get(k) for k in ("host_update_s", "host_prep_s",
                                           "host_adam_s", "threads")}
            for k in ("d2h", "h2d"):
                ev = rec.get(k)
                row[f"{k}_ms"] = (ev[0].elapsed_time(ev[1])
                                  if ev and len(ev) == 2 and ev[0] is not None
                                  else None)
            out.append(row)
        return out

    def close(self) -> None:
        """Finish the update in flight and stop the worker (idempotent)."""
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
            self.landing = self.staging = None
            for b in self._pinned:
                b.release()
            self._pinned = []
