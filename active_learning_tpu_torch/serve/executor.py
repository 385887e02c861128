"""The single device-executor loop behind the scoring service (the JAX
package's ``serve/executor.py``).

One thread owns the device: it takes bucket-padded microbatches from a
thread-safe inbox, runs the scoring steps, and resolves each request
entry's future on its event loop.  Design decisions:

  * **The steps are the offline steps.**  Scores come from
    ``strategies/scoring.make_prob_stats_step`` and ``make_embed_step``,
    the steps the offline samplers use, so a served score is the offline
    score at the same batch shape.
  * **Every bucket is warmed before the first request.**  ``warmup()``
    runs both steps over every bucket of the batcher's ladder once, so
    cuDNN's per-shape setup and the kernels' builds never land on a
    request.  There is no compile cache to count; ``/metrics`` reports
    the kernels' launch counts instead.
  * **Overlapped H2D.**  A feeder thread copies each batch into pinned
    host memory and starts its host-to-device copy on a side stream,
    recording an event; the compute thread makes its stream wait on the
    event.  The copy of batch n+1 runs while batch n computes, and at
    most ``PREFETCH_DEPTH`` batches are staged on the device.
  * **The s2d stem's layout on the host.**  For a model with the s2d
    stem each batch is re-laid as space-to-depth rows before its pinned
    copy, as the offline scoring pass does; clients still send ``[H, W,
    3]`` rows, and warmup stages the same shapes.
  * **Hot checkpoint reload between batches.**  The executor polls the
    experiment's checkpoint directory at a bounded cadence through
    ``train/checkpoint.BestCkptWatcher`` and copies a newer round's
    ``best_rd_{n}`` into the model between batches.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.pipeline import space_to_depth
from ..ops import bn_act as bn_act_lib
from ..ops import prob_stats as prob_stats_lib
from ..strategies import scoring
from ..telemetry import diagnostics as diag_lib
from ..train import checkpoint as ckpt_lib
from ..models.weights import load_flax_variables
from ..utils.logging import get_logger

_SHUTDOWN = object()

# Batches staged on the device ahead of the one computing: one copy in
# flight behind one compute hides the copy without holding more memory.
PREFETCH_DEPTH = 2

# Keys the prob-stats step yields that /v1/predict and /v1/score serve.
STAT_KEYS = ("pred", "confidence", "margin", "entropy")


def kernel_launches() -> Dict[str, int]:
    """Launch counts of the port's kernels in this process."""
    return {"prob_stats": prob_stats_lib.launches,
            "bn_act": bn_act_lib.launches}


class DeviceExecutor:
    """Owns the device, the model's weights, and the compute thread.

    ``model`` is the eval-mode network already on ``device``; ``view``
    the scoring view.  ``variables`` (a flax variables tree of numpy
    arrays) seeds the weights; with ``ckpt_dir`` and no ``variables``
    the newest ``best_rd_{n}.msgpack`` there is loaded, and re-polled
    every ``reload_every_s`` between batches.  A model with the s2d stem
    gets each batch of ``image_shape`` rows re-laid as space-to-depth
    rows on the host (``host_s2d``).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        view,
        device: torch.device,
        image_shape: Tuple[int, int, int],
        variables: Optional[Dict[str, Any]] = None,
        ckpt_dir: Optional[str] = None,
        reload_every_s: float = 5.0,
    ):
        self.model = model
        self.view = view
        self.device = torch.device(device)
        self.image_shape = tuple(image_shape)
        self.host_s2d = getattr(model, "stem", "default") == "s2d"
        self.ckpt_dir = ckpt_dir
        self.reload_every_s = float(reload_every_s)
        self.logger = get_logger()

        self.served_round = -1
        self._watcher = (ckpt_lib.BestCkptWatcher(ckpt_dir)
                         if ckpt_dir is not None else None)
        if variables is None:
            if ckpt_dir is None:
                raise ValueError("need variables or ckpt_dir")
            variables = self._load_latest(required=True)
        load_flax_variables(self.model, variables)

        self._steps = {
            "prob_stats": scoring.make_prob_stats_step(view),
            "embed": scoring.make_embed_step(view, with_probs=True),
        }
        self._inq: "queue.Queue" = queue.Queue()
        self._ready: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._threads: List[threading.Thread] = []
        self._h2d_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._last_reload_check = 0.0
        self._lock = threading.Lock()
        self.stats = {"batches": 0, "rows": 0, "reloads": 0,
                      "warm_buckets": []}
        # Every served batch's margins fold into a live histogram; a hot
        # reload makes it the baseline of the next checkpoint's drift.
        self.score_drift = diag_lib.ServeScoreDrift(key="margin")

    # -- checkpoint (re)loading ------------------------------------------

    def _load_latest(self, required: bool = False):
        polled = self._watcher.poll()
        if polled is None and required and self.served_round < 0:
            # At startup only "nothing on disk" is fatal; a checkpoint
            # whose weights/tag publish is racing settles within a
            # publish, so retry briefly.
            path, _ = ckpt_lib.latest_best_ckpt(self.ckpt_dir)
            if path is None:
                raise FileNotFoundError(
                    f"no best_rd_*.msgpack under {self.ckpt_dir}")
            for _ in range(50):
                time.sleep(0.1)
                polled = self._watcher.poll()
                if polled is not None:
                    break
            else:
                raise RuntimeError(
                    f"best checkpoint under {self.ckpt_dir} never "
                    "settled (weights/tag publish kept racing)")
        if polled is None:
            return None
        variables, rd, tag = polled
        self.served_round = rd
        self.logger.info(
            f"serve: loaded best checkpoint of round {rd}"
            + (f" (best epoch {tag[1]})" if tag else ""))
        return variables

    def maybe_reload(self, now: Optional[float] = None) -> bool:
        """Between-batches hot reload at a bounded cadence.  Runs on the
        executor thread; safe to call from tests directly."""
        if self.ckpt_dir is None:
            return False
        now = time.monotonic() if now is None else now
        if now - self._last_reload_check < self.reload_every_s:
            return False
        self._last_reload_check = now
        prev_round = self.served_round
        variables = self._load_latest()
        if variables is None:
            return False
        load_flax_variables(self.model, variables)
        self.score_drift.rebaseline(prev_round)
        with self._lock:
            self.stats["reloads"] += 1
        return True

    # -- host -> device -----------------------------------------------------

    def _to_device(self, host_batch: Dict[str, np.ndarray]):
        """(device batch, ready event or None).  On the card: a copy into
        pinned memory, then a non-blocking H2D copy on the side stream."""
        arr = host_batch["image"]
        if self.host_s2d:
            arr = space_to_depth(arr)
        if self.device.type == "cpu":
            return {"image": torch.from_numpy(np.array(arr))}, None
        pinned = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=True)
        pinned.numpy()[...] = arr
        with torch.cuda.stream(self._h2d_stream):
            images = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._h2d_stream)
        return {"image": images}, ready

    def _on_compute_stream(self, dev_batch, ready) -> None:
        if ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        # The batch was allocated on the side stream; tell the caching
        # allocator it is used on this one too.
        dev_batch["image"].record_stream(stream)

    # -- warmup -------------------------------------------------------------

    def warmup(self, buckets: Sequence[int]) -> None:
        """Run both steps over every bucket once (cuDNN's per-shape set-up
        and the kernels' builds happen here, not on a request)."""
        h, w, c = self.image_shape
        for b in sorted(set(int(x) for x in buckets)):
            dev, ready = self._to_device(
                {"image": np.zeros((b, h, w, c), dtype=np.uint8)})
            self._on_compute_stream(dev, ready)
            for step in self._steps.values():
                for v in step(self.model, dev).values():
                    v.cpu()
            with self._lock:
                self.stats["warm_buckets"].append(b)

    # -- the device loop --------------------------------------------------

    def start(self) -> None:
        if self._threads:
            return
        self._threads = [
            threading.Thread(target=self._feed, name="al-serve-h2d",
                             daemon=True),
            threading.Thread(target=self._run, name="al-serve-executor",
                             daemon=True)]
        for t in self._threads:
            t.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Process everything queued, then stop both threads.  FIFO: the
        shutdown sentinel queues behind in-flight batches."""
        if not self._threads:
            return
        self._inq.put(_SHUTDOWN)
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []

    def submit_batch(self, host_batch: Dict[str, np.ndarray],
                     entries: List, want_embed: bool) -> None:
        """Batcher dispatch target (thread-safe, non-blocking)."""
        self._inq.put((host_batch, entries, want_embed))

    def _feed(self) -> None:
        """Feeder thread: stage each batch on the device.  A failed copy
        rides along as a marker and fails only its own batch."""
        while True:
            item = self._inq.get()
            if item is _SHUTDOWN:
                self._ready.put(_SHUTDOWN)
                return
            host_batch, entries, want_embed = item
            try:
                dev, ready = self._to_device(host_batch)
                self._ready.put((dev, ready, entries, want_embed, None))
            except Exception as exc:  # noqa: BLE001 - per-batch isolation
                self._ready.put((None, None, entries, want_embed, exc))

    def _run(self) -> None:
        while True:
            item = self._ready.get()
            if item is _SHUTDOWN:
                return
            dev_batch, ready, entries, want_embed, put_exc = item
            if put_exc is not None:
                self.logger.error(f"serve: h2d copy failed: {put_exc!r}")
                for e in entries:
                    _reject(e.future, put_exc)
                continue
            try:
                self.maybe_reload()
                self._on_compute_stream(dev_batch, ready)
                out = self._steps["prob_stats"](self.model, dev_batch)
                host = {k: out[k].cpu().numpy() for k in STAT_KEYS}
                if want_embed:
                    emb = self._steps["embed"](self.model, dev_batch)
                    host["embedding"] = emb["embedding"].cpu().numpy()
                with self._lock:
                    self.stats["batches"] += 1
                    self.stats["rows"] += sum(e.n for e in entries)
                for e in entries:
                    sl = slice(e.offset, e.offset + e.n)
                    # Real rows only: the bucket's padding tail would
                    # poison the distribution.
                    self.score_drift.observe(host["margin"][sl])
                    payload = {k: v[sl] for k, v in host.items()
                               if k != "embedding" or e.want_embed}
                    payload["round"] = self.served_round
                    _resolve(e.future, payload)
            except Exception as exc:  # noqa: BLE001 - per-batch isolation
                self.logger.exception("serve: batch failed")
                for e in entries:
                    _reject(e.future, exc)


def _resolve(future, payload) -> None:
    loop = future.get_loop()
    loop.call_soon_threadsafe(
        lambda: future.set_result(payload) if not future.done() else None)


def _reject(future, exc: Exception) -> None:
    loop = future.get_loop()
    loop.call_soon_threadsafe(
        lambda: future.set_exception(exc) if not future.done() else None)
