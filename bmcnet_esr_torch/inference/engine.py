"""Recurrent inference over event files: chunked rollout + per-window metrics.

Counterpart of ``bmcnet_esr_tpu/inference/engine.py``.  The JAX engine runs
each chunk as one compiled ``lax.scan`` (``engine.py:298-333``); here the
chunk body is a Python loop over its windows that enqueues the model's CUDA
work asynchronously and synchronizes once per chunk, when the per-window
metrics come back to the host.  Behaviour kept from the JAX engine:

* the recurrent state initializes once per file and persists across all
  windows; the rollout is stride-1 over consecutive (w, w+1) window pairs;
* a chunk of ``steps`` windows rasterizes ``steps + 1`` input windows (one
  window of overlap) and ``steps`` GT windows on the device, in one
  rasterizer launch each (``kernels/rasterize.py``);
* per-window ``esr_mse`` (bicubic shape fix-up when the prediction and GT
  resolutions differ), ``bicubic_mse``, ``time`` (ms per window, wall time
  from enqueue to the chunk's synchronization), ``params`` (M, tied aliases
  once) and ``macs`` (M per window, from ``torch.utils.flop_counter`` over
  one model forward: convolutions and matrix products; the JAX engine
  takes XLA's cost analysis of the whole chunk body instead);
* extra metrics stacked in the user's order (``engine.py:321-327``);
* both LR and GT resolutions checked for batched groups;
* dataset augmentation forced off (``engine.py:163-179``);
* ``gt_available`` and ``h2d_overlap_skips`` in every result;
* a double-buffered host loader thread; uploads go from pinned memory with
  ``non_blocking=True`` on a side stream, and with ``h2d_overlap`` the next
  chunk's upload is enqueued while the current chunk computes;
* int8 models: static per-lane scales calibrated over (up to) the first 16
  window pairs of every file or batched group (``engine.py:260-283``),
  never overwriting scales the caller installed.

Not ported: Orbax / EMA checkpoints (ROADMAP.md Queue 1 item 7) and
``mesh=`` sharding (item 8).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from bmcnet_esr_torch.data import DatasetConfig, EventH5Dataset
from bmcnet_esr_torch.losses.restore import psnr_metric, ssim_metric
from bmcnet_esr_torch.models import (
    BMCNet,
    BMCNetPlain,
    act_scales,
    calibrate_act_scales,
    count_params,
    load_checkpoint,
)
from bmcnet_esr_torch.ops.batch import batch_counts_from_compact, compact_events
from bmcnet_esr_torch.ops.resize import resize_bicubic
from bmcnet_esr_torch.utils import MetricTracker, YamlResultLogger, resolve_device, strict_fp32
from bmcnet_esr_torch.vis import EventVisualizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# int8 serving dtypes -> the model's quant mode (models/layers.py); the model
# itself computes in bf16 around the int8 convolutions
INT8_DTYPES = {"int8": True, "int8_pconv": "pconv", "int8_p1x1": "p1x1",
               "int8_pall": "pall", "int8_pquant": "pquant", "int8_chain": "chain",
               "int8_chainq": "chainq"}
_STREAMS = ("lr_event_img", "hr_esr_event_img", "hr_bicubic_event_img", "hr_gt_event_img")

def _calib_pairs(inp_xy: torch.Tensor, inp_p: torch.Tensor, inp_res) -> torch.Tensor:
    """A chunk's compact input windows -> its ``[S, B, 2, H, W, 2]`` pairs."""
    frames = batch_counts_from_compact(inp_xy, inp_p, inp_res)
    return torch.stack([frames[:-1], frames[1:]], 2)


# load_chunk(pos, steps) -> ((inp_xy, inp_p), (gt_xy, gt_p)): compact numpy
# windows pos .. pos+steps for the input ([steps+1, B, 2, N] / [steps+1, B, N])
# and pos+1 .. pos+steps for the GT ([steps, B, 2, M] / [steps, B, M])
ChunkLoader = Callable[[int, int], Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...]]]


def load_model_for_inference(
    checkpoint_path: str,
    scale: int,
    n_c: int = 128,
    n_b: int = 5,
    variant: str = "full",
    dtype: str = "float32",
    device="cuda",
) -> torch.nn.Module:
    """Build the model, load a ``.pth`` / ``.npz`` checkpoint and place it on
    ``device`` (channels-last, eval mode).  The JAX version returns
    ``(model, variables)``; here the weights live in the module.

    ``dtype='bfloat16'`` is the serving path (float32 parameters, bf16
    activations); ``float32`` is the parity default and turns TF32 off.
    The ``int8*`` dtypes (:data:`INT8_DTYPES`) build the bf16 model in that
    int8 quant mode; the engine calibrates its static scales.
    """
    if dtype not in DTYPES and dtype not in INT8_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES) + sorted(INT8_DTYPES)}, "
                         f"got {dtype!r}")
    dev = resolve_device(device)
    cls = BMCNetPlain if variant == "plain" else BMCNet
    quant = INT8_DTYPES.get(dtype, False)
    model = cls(scale=scale, n_c=n_c, n_b=n_b, dtype=DTYPES.get(dtype, torch.bfloat16),
                quant=quant)
    model.load_state_dict(load_checkpoint(checkpoint_path), strict=True)
    strict_fp32()
    return model.to(dev, memory_format=torch.channels_last).eval()


def _chunk_bounds(n_windows: int, chunk_size: int) -> List[Tuple[int, int]]:
    return [(pos, min(chunk_size, n_windows - pos)) for pos in range(0, n_windows, chunk_size)]


@dataclasses.dataclass
class _ChunkOut:
    esr: np.ndarray     # [S, B]
    bicm: np.ndarray    # [S, B]
    extras: np.ndarray  # [S, B, len(extra_metrics)]
    dt_ms: float        # wall ms per window
    images: Optional[Tuple[np.ndarray, ...]] = None  # lr, pred, bicubic, gt [S, B, ...]


class InferenceEngine:
    def __init__(
        self,
        model: torch.nn.Module,
        dataset_config: DatasetConfig,
        *,
        chunk_size: int = 32,
        visualize: bool = True,
        vis_color_scheme: str = "blue_red",
        extra_metrics: Sequence[str] = (),
        h2d_overlap: bool = True,
        device="cuda",
    ):
        """``h2d_overlap``: enqueue the NEXT chunk's upload while the current
        chunk computes (bit-identical to the serial path)."""
        self.device = resolve_device(device)
        strict_fp32()
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        if dataset_config.augment.enabled:
            # stochastic per-window augmentation would flip consecutive
            # windows of the same recurrent pair differently
            logging.getLogger(__name__).warning(
                "dataset augment is enabled in an inference config; "
                "disabling it for the rollout (stochastic per-window "
                "augmentation breaks stride-1 window pairing)"
            )
            dataset_config = dataclasses.replace(
                dataset_config,
                augment=dataclasses.replace(dataset_config.augment, enabled=False),
            )
        self.config = dataset_config
        self.chunk_size = chunk_size
        self.visualize = visualize
        self.vis = EventVisualizer()
        self.vis_color_scheme = vis_color_scheme
        self.extra_metrics = tuple(extra_metrics)
        unknown = set(self.extra_metrics) - {"psnr", "ssim"}
        if unknown:
            raise ValueError(
                f"unknown extra_metrics {sorted(unknown)}; choose from ('psnr', 'ssim')"
            )
        self.h2d_overlap = bool(h2d_overlap)
        self._overlap_skips = 0
        self._macs: Dict[Tuple, float] = {}  # MACs per window, by (batch, input resolution)
        # int8: True once this engine installed the static scales, which it
        # then derives anew for every file / group, so each lane's scale
        # comes from its own stream; scales the caller installed are kept
        self._auto_quant = False
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self.params_m = count_params(self.model) / 1e6

    # -- host -> device ------------------------------------------------------

    def _load(self, load_chunk: ChunkLoader, pos: int, steps: int):
        """Loader-thread body: read a chunk and pin it for the upload."""
        inp_c, gt_c = load_chunk(pos, steps)
        if any(len(a) != steps + 1 for a in inp_c) or any(len(a) != steps for a in gt_c):
            raise ValueError(
                f"load_chunk({pos}, {steps}) must return {steps + 1} input and {steps} GT "
                f"windows, got {[len(a) for a in inp_c]} and {[len(a) for a in gt_c]}"
            )
        arrays = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (*inp_c, *gt_c))
        if self.device.type == "cuda":
            arrays = tuple(a.pin_memory() for a in arrays)
        return arrays

    def _upload(self, arrays):
        """Enqueue the upload; returns ``(device tensors, ready event)``."""
        if self.device.type != "cuda":
            return arrays, None
        with torch.cuda.stream(self._copy_stream):
            dev = tuple(a.to(self.device, non_blocking=True) for a in arrays)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, ready

    def _adopt(self, uploaded):
        """Make an upload safe to use on the compute stream."""
        dev, ready = uploaded
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in dev:
                t.record_stream(stream)
        return dev

    # -- one chunk -----------------------------------------------------------

    def _macs_per_window(self, pair: torch.Tensor, carry) -> float:
        model = self.model
        if model.quant:
            # the int8 kernels launch through ctypes, out of the flop
            # counter's sight: count the same network in float, shapes only
            with torch.device("meta"):
                model = type(model)(model.scale, model.n_c, model.n_b, model.repeat,
                                    dtype=model.dtype)
            pair, carry = pair.to("meta"), tuple(c.to("meta") for c in carry)
        with FlopCounterMode(display=False) as fc:
            model(pair, *carry)
        return fc.get_total_flops() / 2.0 / pair.shape[0]

    def _maybe_calibrate(self, dev, inp_res, batch: int) -> None:
        """int8 static scales from (up to) 16 recurrent steps over the first
        chunk's windows, per lane (``models/quant.calibrate_act_scales``)."""
        if not self.model.quant or (act_scales(self.model) and not self._auto_quant):
            return
        pairs = _calib_pairs(dev[0], dev[1], inp_res)
        calibrate_act_scales(self.model, pairs,
                             self.model.init_state(batch, *inp_res, device=self.device))
        self._auto_quant = True

    def _run_chunk(self, carry, dev, inp_res, gt_res, want_images: bool):
        """Enqueue one chunk; returns the new carry and device results."""
        inp_xy, inp_p, gt_xy, gt_p = dev
        frames = batch_counts_from_compact(inp_xy, inp_p, inp_res)  # [S+1, B, H, W, 2]
        gts = batch_counts_from_compact(gt_xy, gt_p, gt_res)        # [S, B, kH, kW, 2]
        pairs = torch.stack([frames[:-1], frames[1:]], 2)          # [S, B, 2, H, W, 2]
        esr, bicm, extras, preds, bics = [], [], [], [], []
        for pair, gt in zip(pairs, gts):
            carry = self.model(pair, *carry)
            pred = carry[-1]
            pred_fit = resize_bicubic(pred, gt_res) if pred.shape[1:3] != gt.shape[1:3] else pred
            bic = resize_bicubic(pair[:, 1], gt_res)
            esr.append(torch.mean(torch.square(pred_fit - gt), dim=(1, 2, 3)))
            bicm.append(torch.mean(torch.square(bic - gt), dim=(1, 2, 3)))
            cols = []
            for m in self.extra_metrics:  # the USER'S order: column mi <-> extra_metrics[mi]
                fn = psnr_metric if m == "psnr" else ssim_metric
                cols.append(torch.stack([
                    fn(p.permute(2, 0, 1).float(), g.permute(2, 0, 1))
                    for p, g in zip(pred_fit, gt)
                ]))
            extras.append(torch.stack(cols, 1) if cols else gt.new_zeros((gt.shape[0], 0)))
            if want_images:
                preds.append(pred_fit)
                bics.append(bic)
        out = [torch.stack(esr), torch.stack(bicm), torch.stack(extras)]
        if want_images:
            out.append((frames[1:], torch.stack(preds), torch.stack(bics), gts))
        return carry, out

    # -- the chunked rollout ---------------------------------------------------

    def _rollout(self, chunk_bounds, load_chunk: ChunkLoader, batch: int, inp_res, gt_res,
                 want_images: bool, consume: Callable[[int, int, _ChunkOut], None]) -> float:
        """Double-buffered rollout: the loader thread reads chunk N+1 while
        chunk N computes; ``consume(pos, steps, out)`` gets each chunk's host
        results in order.  Returns the MACs per window of one stream."""
        self._overlap_skips = 0
        pool = ThreadPoolExecutor(max_workers=1)
        try:
            with torch.inference_mode():
                carry = self.model.init_state(batch, *inp_res, device=self.device)
                pending = pool.submit(self._load, load_chunk, *chunk_bounds[0])
                next_up = None
                for ci, (pos, steps) in enumerate(chunk_bounds):
                    if next_up is None:
                        arrays = pending.result()
                        if ci + 1 < len(chunk_bounds):
                            pending = pool.submit(self._load, load_chunk, *chunk_bounds[ci + 1])
                        next_up = self._upload(arrays)
                    dev = self._adopt(next_up)
                    next_up = None
                    if ci == 0:
                        self._maybe_calibrate(dev, inp_res, batch)
                    if (batch, inp_res) not in self._macs:
                        # outside the timed region: the flop count (one extra
                        # forward per shape, outputs dropped) doubles as a warm-up
                        pair0 = torch.zeros((batch, 2, *inp_res, 2), device=self.device)
                        self._macs[batch, inp_res] = self._macs_per_window(pair0, carry)
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)

                    t0 = time.perf_counter()
                    carry, res = self._run_chunk(carry, dev, inp_res, gt_res, want_images)
                    # upload the NEXT chunk while this one computes, but only
                    # when its host read has already finished: a read still
                    # running would bill host IO to this chunk's time
                    if self.h2d_overlap and ci + 1 < len(chunk_bounds):
                        if pending.done():
                            arrays = pending.result()
                            if ci + 2 < len(chunk_bounds):
                                pending = pool.submit(
                                    self._load, load_chunk, *chunk_bounds[ci + 2]
                                )
                            next_up = self._upload(arrays)
                        else:
                            self._overlap_skips += 1
                    esr = res[0].cpu().numpy()  # synchronizes the chunk
                    dt_ms = (time.perf_counter() - t0) * 1000.0 / steps
                    out = _ChunkOut(esr, res[1].cpu().numpy(), res[2].cpu().numpy(), dt_ms)
                    if want_images:
                        out.images = tuple(t.float().cpu().numpy() for t in res[3])
                    consume(pos, steps, out)
        finally:
            # an in-flight read must finish or be cancelled before the caller
            # closes the dataset under it
            pool.shutdown(wait=True, cancel_futures=True)
        return self._macs[batch, inp_res]

    def _new_tracker(self) -> MetricTracker:
        track = MetricTracker(
            ["esr_mse", "bicubic_mse", "time", "params", "macs"]
            + [f"esr_{m}" for m in self.extra_metrics]
        )
        track.update("params", self.params_m)
        return track

    def _finish(self, result: Dict) -> Dict:
        # without GT events the MSEs are against the zero sentinel image
        result["gt_available"] = bool(self.config.need_gt_events)
        if self.h2d_overlap:
            result["h2d_overlap_skips"] = self._overlap_skips
        return result

    def infer_windows(
        self,
        load_chunk: ChunkLoader,
        n_windows: int,
        inp_res: Tuple[int, int],
        gt_res: Tuple[int, int],
        output_dir: Optional[str] = None,
        logger: Optional[YamlResultLogger] = None,
        return_per_window: bool = False,
    ) -> Dict:
        """Roll one stream of ``n_windows`` window pairs out of ``load_chunk``
        (batch 1).  :meth:`infer_file` feeds it from an h5 file; any other
        source of compact windows can call it directly."""
        if n_windows < 1:
            raise ValueError("not enough windows for a rollout")
        img_dirs = {}
        if self.visualize and output_dir is not None:
            for name in _STREAMS:
                img_dirs[name] = os.path.join(output_dir, name)
                os.makedirs(img_dirs[name], exist_ok=True)
        track = self._new_tracker()
        pw_esr: List[float] = []
        pw_bic: List[float] = []
        img_pool = ThreadPoolExecutor(max_workers=4) if img_dirs else None
        img_futures: List = []

        def consume(pos: int, steps: int, out: _ChunkOut) -> None:
            for s in range(steps):
                pw_esr.append(float(out.esr[s, 0]))
                pw_bic.append(float(out.bicm[s, 0]))
                track.update("esr_mse", float(out.esr[s, 0]))
                track.update("bicubic_mse", float(out.bicm[s, 0]))
                track.update("time", out.dt_ms)
                for mi, mname in enumerate(self.extra_metrics):
                    track.update(f"esr_{mname}", float(out.extras[s, 0, mi]))
            if img_dirs:
                lr, pred, bic, gt = out.images
                for s in range(steps):
                    img_futures.append(img_pool.submit(
                        self._save_streams, img_dirs, pos + s,
                        lr[s, 0], pred[s, 0], bic[s, 0], gt[s, 0],
                    ))
                while len(img_futures) > 2 * self.chunk_size:  # bound the backlog
                    img_futures.pop(0).result()

        try:
            macs = self._rollout(
                _chunk_bounds(n_windows, self.chunk_size), load_chunk, 1,
                tuple(inp_res), tuple(gt_res), bool(img_dirs), consume,
            )
            for f in img_futures:  # a failed PNG write surfaces here
                f.result()
        finally:
            if img_pool is not None:
                img_pool.shutdown(wait=True, cancel_futures=True)
        track.update("macs", macs / 1e6)
        result = self._finish(track.result())
        if logger is not None:
            logger.log_dict(result, "evaluation results")
        if return_per_window:
            result["per_window"] = {
                "esr_mse": np.asarray(pw_esr),
                "bicubic_mse": np.asarray(pw_bic),
            }
        return result

    def infer_file(
        self,
        data_path: str,
        output_dir: Optional[str] = None,
        logger: Optional[YamlResultLogger] = None,
        return_per_window: bool = False,
    ) -> Dict:
        """Roll out one h5 file (``return_per_window`` adds the raw
        per-window metric arrays under ``result['per_window']``)."""
        ds = EventH5Dataset(data_path, self.config)
        try:
            def load_chunk(pos: int, steps: int):
                items = [ds.get_window(w) for w in range(pos, pos + steps + 1)]
                inp_ev = np.stack([it["inp_events"] for it in items])[:, None]
                gt_ev = np.stack([it["gt_events"] for it in items[1:]])[:, None]
                return compact_events(inp_ev), compact_events(gt_ev)

            if len(ds) < 2:
                raise ValueError(f"{data_path}: not enough windows for a rollout")
            return self.infer_windows(
                load_chunk, len(ds) - 1, ds.layout.inp_resolution, ds.layout.gt_resolution,
                output_dir, logger, return_per_window,
            )
        finally:
            ds.close()

    def _save_streams(self, dirs, i, lr, pred, bic, gt):
        cs = self.vis_color_scheme
        name = f"{i:09d}.png"
        self.vis.plot_event_cnt(lr, True, os.path.join(dirs["lr_event_img"], name), cs)
        self.vis.plot_event_cnt(np.round(pred), True, os.path.join(dirs["hr_esr_event_img"], name), cs)
        self.vis.plot_event_cnt(bic, True, os.path.join(dirs["hr_bicubic_event_img"], name), cs)
        self.vis.plot_event_cnt(gt, True, os.path.join(dirs["hr_gt_event_img"], name), cs)

    # -- batched multi-stream rollout -----------------------------------------

    def infer_file_batch(self, data_paths: List[str]) -> List[Dict]:
        """Roll out several same-resolution files as one batched stream set.
        Each stream's numbers equal its own :meth:`infer_file` run up to the
        floating-point reassociation that batch-size-dependent convolution
        algorithms bring; shorter files pad with zero-event windows whose
        metrics are masked.  No PNG streams in batched mode."""
        dss = [EventH5Dataset(p, self.config) for p in data_paths]
        try:
            inp_res = tuple(dss[0].layout.inp_resolution)
            gt_res = tuple(dss[0].layout.gt_resolution)
            for ds in dss[1:]:
                # BOTH resolutions must match: inputs that round to one LR
                # shape can still differ at the GT scale, and rasterizing at
                # the wrong GT resolution silently drops boundary rows
                if (tuple(ds.layout.inp_resolution) != inp_res
                        or tuple(ds.layout.gt_resolution) != gt_res):
                    raise ValueError("batched inference needs equal resolutions")
            b = len(dss)
            n_windows = [len(ds) - 1 for ds in dss]
            if min(n_windows) < 1:
                raise ValueError("every file needs at least one (w, w+1) pair")
            inp_pad = max(ds.padded_window for ds in dss)
            gt_pad = max(ds.gt_window for ds in dss) if self.config.need_gt_events else 1

            def pad_to(ev: np.ndarray, size: int) -> np.ndarray:
                out = np.zeros((4, size), np.float32)
                out[:, : ev.shape[1]] = ev
                return out

            def load_chunk(pos: int, steps: int):
                inp = np.zeros((steps + 1, b, 4, inp_pad), np.float32)
                gt = np.zeros((steps, b, 4, gt_pad), np.float32)
                for j, ds in enumerate(dss):
                    for s in range(steps + 1):
                        w = pos + s
                        if w <= n_windows[j]:  # windows 0..n_windows[j] exist
                            item = ds.get_window(w)
                            inp[s, j] = pad_to(item["inp_events"], inp_pad)
                            if s >= 1:
                                gt[s - 1, j] = pad_to(item["gt_events"], gt_pad)
                return compact_events(inp), compact_events(gt)

            tracks = [self._new_tracker() for _ in dss]

            def consume(pos: int, steps: int, out: _ChunkOut) -> None:
                for s in range(steps):
                    for j, t in enumerate(tracks):
                        if pos + s >= n_windows[j]:
                            continue  # padded tail of a shorter file
                        t.update("esr_mse", float(out.esr[s, j]))
                        t.update("bicubic_mse", float(out.bicm[s, j]))
                        t.update("time", out.dt_ms)
                        for mi, mname in enumerate(self.extra_metrics):
                            t.update(f"esr_{mname}", float(out.extras[s, j, mi]))

            macs = self._rollout(
                _chunk_bounds(max(n_windows), self.chunk_size), load_chunk, b,
                inp_res, gt_res, False, consume,
            )
        finally:
            for ds in dss:
                ds.close()
        results = []
        for t in tracks:
            t.update("macs", macs / 1e6)
            results.append(self._finish(t.result()))
        return results

    # -- datalist entry point --------------------------------------------------

    def infer_datalist(
        self,
        data_paths: List[str],
        output_path: str,
        model_desc: str = "",
        batch_streams: int = 1,
    ) -> Dict[str, Dict]:
        """Per-file dirs + YAMLs and the aggregated ``inference_all.yml``.
        ``batch_streams > 1`` rolls same-resolution files out together (no
        PNG streams in that mode)."""
        os.makedirs(output_path, exist_ok=True)
        all_logger = YamlResultLogger(os.path.join(output_path, "inference_all.yml"))
        all_logger.log_info(f"inference {model_desc} on {data_paths}")

        results = []
        if batch_streams > 1:
            for g0 in range(0, len(data_paths), batch_streams):
                group = data_paths[g0 : g0 + batch_streams]
                for data_path, result in zip(group, self.infer_file_batch(group)):
                    name = os.path.basename(data_path)
                    root = os.path.join(output_path, name)
                    os.makedirs(root, exist_ok=True)
                    with YamlResultLogger(os.path.join(root, "inference.yml")) as logger:
                        logger.log_info(f"inference {model_desc} on {data_path}")
                        logger.log_dict(result, "evaluation results")
                    results.append((name, result))
            return self._aggregate(results, all_logger)

        for data_path in data_paths:
            name = os.path.basename(data_path)
            root = os.path.join(output_path, name)
            os.makedirs(root, exist_ok=True)
            with YamlResultLogger(os.path.join(root, "inference.yml")) as logger:
                logger.log_info(f"inference {model_desc} on {data_path}")
                result = self.infer_file(data_path, os.path.join(root, "event_img"), logger)
            results.append((name, result))
        return self._aggregate(results, all_logger)

    @staticmethod
    def _aggregate(results, all_logger) -> Dict[str, Dict]:
        breakdown: Dict[str, Dict] = {}
        for name, res in results:
            for k, v in res.items():
                breakdown.setdefault(k, {})[name] = v
        means = {k: float(np.mean(list(sub.values()))) for k, sub in breakdown.items()}
        all_logger.log_dict(breakdown, "breakdown results for each data")
        all_logger.log_dict(means, "mean results for the whole data")
        all_logger.close()
        return {"breakdown": breakdown, "mean": means}
