"""LPIPS calibration training: the ``DistModel`` training half.

Counterpart of ``bmcnet_esr_tpu/losses/lpips_train.py`` (reference
PerceptualSimilarity ``models/dist_model.py`` and ``networks_basic.py``):

* ``Dist2LogitLayer`` / ``BCERankingLoss`` (``networks_basic.py:123-150``):
  :func:`init_dist2logit`, :func:`dist2logit`, :func:`bce_ranking_loss`;
* :class:`LPIPSTrainer`: Adam over the linear heads and the logit net (and
  the backbone with ``pnet_tune``) with ``betas=(beta1, 0.999)``, the lin
  weights clamped to >= 0 after every step, the on-demand linear decay, and
  dropout of the squared feature differences in training steps only
  (``dist_model.py:92-98,124-214``);
* :func:`compute_accuracy`, :func:`voc_ap`, :func:`score_2afc_dataset` and
  :func:`score_jnd_dataset` (``dist_model.py:169-288``).

As in the JAX package, only the trainable heads are clamped: the reference
also clamps the frozen 1x1 convolutions of the squeeze backbone.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bmcnet_esr_torch.losses.lpips import LPIPS
from bmcnet_esr_torch.utils.device import resolve_device, strict_fp32

Tensor = torch.Tensor


def init_dist2logit(seed: int = 0, chn_mid: int = 32) -> Dict[str, Tensor]:
    """torch's default init of the 5 -> mid -> mid -> 1 stack of 1x1 convs:
    U(-1/sqrt(c_in), 1/sqrt(c_in)) for weights and biases, drawn with
    numpy as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Tensor] = {}
    for i, (cin, cout) in enumerate([(5, chn_mid), (chn_mid, chn_mid), (chn_mid, 1)]):
        bound = 1.0 / math.sqrt(cin)
        params[f"w{i}"] = torch.tensor(rng.uniform(-bound, bound, (cout, cin)), dtype=torch.float32)
        params[f"b{i}"] = torch.tensor(rng.uniform(-bound, bound, (cout,)), dtype=torch.float32)
    return params


def _dist2logit_raw(params: Mapping[str, Tensor], d0: Tensor, d1: Tensor,
                    eps: float = 0.1) -> Tensor:
    x = torch.cat([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)], dim=1)
    for i in range(3):
        x = torch.einsum("oc,bchw->bohw", params[f"w{i}"], x) + params[f"b{i}"][None, :, None, None]
        if i < 2:
            x = torch.where(x >= 0, x, 0.2 * x)
    return x


def dist2logit(params: Mapping[str, Tensor], d0: Tensor, d1: Tensor, eps: float = 0.1) -> Tensor:
    """Two distance maps ``[N, 1, H, W]`` -> the probability that a human
    prefers the second (``networks_basic.py:128-138``)."""
    return torch.sigmoid(_dist2logit_raw(params, d0, d1, eps))


def bce_ranking_loss(params: Mapping[str, Tensor], d0: Tensor, d1: Tensor, judge: Tensor,
                     eps: float = 0.1) -> Tensor:
    """BCE of the logit net's prediction against ``judge`` in [-1, 1],
    computed from the logits (``softplus``), so a saturated sigmoid keeps
    finite gradients (``networks_basic.py:147-150``)."""
    per = (judge + 1.0) / 2.0
    z = _dist2logit_raw(params, d0, d1, eps)
    return torch.mean(per * F.softplus(-z) + (1.0 - per) * F.softplus(z))


def compute_accuracy(d0: Tensor, d1: Tensor, judge: Tensor) -> Tensor:
    """Per-triplet agreement with the human ``judge`` in [0, 1]
    (``dist_model.py:169-173``)."""
    d1_lt_d0 = (d1 < d0).to(torch.float32).reshape(-1)
    j = judge.to(torch.float32).reshape(-1)
    return d1_lt_d0 * j + (1.0 - d1_lt_d0) * (1.0 - j)


class LPIPSTrainer:
    """Train an LPIPS's heads (and, with ``pnet_tune``, its backbone) on 2AFC
    triplets, as ``DistModel.initialize(is_train=True)`` does.

    Args:
      lpips_model: a net-lin :class:`LPIPS` with the initial heads.
      lr, beta1: Adam's (reference defaults 1e-4, 0.5).
      chn_mid: the width of the logit net.
      seed: the logit net's init and the dropout's generator.
      pnet_tune: train the backbone too (``dist_model.py:66``).
      use_dropout: Dropout(0.5) of the squared feature differences in
        training steps (``PNetLin(use_dropout=True)``); :meth:`distance`
        never drops.
      device: where the trainer runs (``"cpu"`` to run on the CPU).
    """

    def __init__(self, lpips_model: LPIPS, *, lr: float = 1e-4, beta1: float = 0.5,
                 chn_mid: int = 32, seed: int = 0, pnet_tune: bool = False,
                 use_dropout: bool = True, device="cuda"):
        if not lpips_model.lpips or lpips_model.lins is None:
            raise ValueError("LPIPSTrainer needs a net-lin LPIPS (lpips=True with lins)")
        if lpips_model.spatial:
            raise ValueError("train on scalar distances (spatial=False), like the reference")
        self.device = resolve_device(device)
        strict_fp32()
        self.lpips = copy.deepcopy(lpips_model).to(self.device)
        self.pnet_tune = bool(pnet_tune)
        self.params: Dict = {
            "lins": [w.detach().clone().requires_grad_(True) for w in self.lpips.lins],
            "logit": {k: v.to(self.device).requires_grad_(True)
                      for k, v in init_dist2logit(seed, chn_mid).items()},
        }
        if self.pnet_tune:
            self.lpips.net.requires_grad_(True)
            self.params["backbone"] = dict(self.lpips.net.named_parameters())
        self.lr0 = float(lr)
        self.lr = float(lr)
        self.use_dropout = bool(use_dropout)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._opt = torch.optim.Adam(self._leaves(), lr=self.lr, betas=(beta1, 0.999), eps=1e-8)
        self._errors: Dict[str, Tensor] = {}

    def _leaves(self) -> List[Tensor]:
        leaves = list(self.params["lins"]) + list(self.params["logit"].values())
        return leaves + list(self.params.get("backbone", {}).values())

    def load_params(self, params: Mapping) -> None:
        """Copy ``params`` (the layout of :attr:`params`, e.g. from
        :func:`bmcnet_esr_torch.models.lpips_params_from_jax`) into the trainer's tensors."""
        with torch.no_grad():
            for w, v in zip(self.params["lins"], params["lins"]):
                w.copy_(torch.as_tensor(np.asarray(v)).reshape(w.shape))
            for k, w in self.params["logit"].items():
                w.copy_(torch.as_tensor(np.asarray(params["logit"][k])))
            for k, w in self.params.get("backbone", {}).items():
                w.copy_(torch.as_tensor(np.asarray(params["backbone"][k])))

    def _drop_masks(self, like: List[Tensor]) -> List[Tensor]:
        return [torch.bernoulli(torch.full_like(f, 0.5), generator=self._gen) * 2.0 for f in like]

    def _distances(self, ref, p0, p1, train: bool) -> Tuple[Tensor, Tensor]:
        lins = self.params["lins"]
        if train and self.use_dropout:
            # the masks take the shapes of the taps' squared differences
            with torch.no_grad():
                shapes = [f.shape for f in self.lpips.features(ref.float())]
            m0 = self._drop_masks([torch.empty(s, device=ref.device) for s in shapes])
            m1 = self._drop_masks([torch.empty(s, device=ref.device) for s in shapes])
        else:
            m0 = m1 = None
        return (self.lpips(ref, p0, drop_masks=m0, lins=lins),
                self.lpips(ref, p1, drop_masks=m1, lins=lins))

    def optimize_parameters(self, batch: Mapping) -> Dict[str, Tensor]:
        """One training step (``dist_model.py:124-129``) on ``ref`` / ``p0``
        / ``p1`` ``[N, 3, H, W]`` in [-1, 1] and ``judge`` (N values in
        [0, 1], the share preferring ``p1``).  Returns ``{'loss_total',
        'acc_r'}`` as device scalars (:meth:`get_current_errors` syncs)."""
        ref, p0, p1, judge = (torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32)
                              .to(self.device) for k in ("ref", "p0", "p1", "judge"))
        self.lpips.train()
        with torch.enable_grad():
            d0, d1 = self._distances(ref, p0, p1, train=True)
            j = judge.reshape(d0.shape)
            loss = bce_ranking_loss(self.params["logit"], d0, d1, j * 2.0 - 1.0)
            self._opt.zero_grad(set_to_none=True)
            loss.backward()
        for group in self._opt.param_groups:
            group["lr"] = self.lr
        self._opt.step()
        with torch.no_grad():
            for w in self.params["lins"]:
                w.clamp_(min=0.0)  # clamp_weights (dist_model.py:129-134)
        acc = torch.mean(compute_accuracy(d0.detach(), d1.detach(), j))
        self._errors = {"loss_total": loss.detach(), "acc_r": acc}
        return dict(self._errors)

    def get_current_errors(self) -> Dict[str, float]:
        """The last step's ``{'loss_total', 'acc_r'}`` as floats."""
        return {k: float(v) for k, v in self._errors.items()}

    def update_learning_rate(self, nepoch_decay: int) -> float:
        """Linear decay: ``lr -= lr0 / nepoch_decay`` (``dist_model.py:206-214``)."""
        self.lr = self.lr - self.lr0 / float(nepoch_decay)
        return self.lr

    @torch.no_grad()
    def distance(self, in0, in1) -> np.ndarray:
        """Distances ``[N]`` under the current parameters, without dropout."""
        self.lpips.eval()
        x0, x1 = (torch.as_tensor(np.asarray(a), dtype=torch.float32).to(self.device)
                  for a in (in0, in1))
        return self.lpips(x0, x1, lins=self.params["lins"]).reshape(-1).cpu().numpy()

    def lin_weights(self) -> List[np.ndarray]:
        """The trained heads, loadable back into :class:`LPIPS`."""
        return [w.detach().cpu().numpy() for w in self.params["lins"]]

    def save_lin_weights(self, path: str) -> str:
        """The heads in the reference's ``.pth`` layout
        (``lin{k}.model.1.weight`` ``[1, C, 1, 1]``)."""
        state = {f"lin{k}.model.1.weight": w.detach().cpu().float()[:, :, None, None].clone()
                 for k, w in enumerate(self.params["lins"])}
        torch.save(state, path)
        return path


# -- evaluation harnesses (dist_model.py:216-288) ------------------------------


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC average precision over a PR curve (``models/__init__.py:124-155``)."""
    rec = np.asarray(rec, np.float64)
    prec = np.asarray(prec, np.float64)
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def score_2afc_dataset(data_iter: Iterable[Dict],
                       dist_fn: Callable[[np.ndarray, np.ndarray], np.ndarray]
                       ) -> Tuple[float, Dict[str, np.ndarray]]:
    """2AFC agreement (``dist_model.py:216-249``): batches of ``ref`` /
    ``p0`` / ``p1`` and ``judge`` in [0, 1]; ties score 0.5."""
    d0s: List[float] = []
    d1s: List[float] = []
    gts: List[float] = []
    for data in data_iter:
        d0s += np.asarray(dist_fn(data["ref"], data["p0"])).reshape(-1).tolist()
        d1s += np.asarray(dist_fn(data["ref"], data["p1"])).reshape(-1).tolist()
        gts += np.asarray(data["judge"]).reshape(-1).tolist()
    d0a, d1a, gta = np.array(d0s), np.array(d1s), np.array(gts)
    scores = (d0a < d1a) * (1.0 - gta) + (d1a < d0a) * gta + (d1a == d0a) * 0.5
    return float(np.mean(scores)), dict(d0s=d0a, d1s=d1a, gts=gta, scores=scores)


def score_jnd_dataset(data_iter: Iterable[Dict],
                      dist_fn: Callable[[np.ndarray, np.ndarray], np.ndarray]
                      ) -> Tuple[float, Dict[str, np.ndarray]]:
    """JND mAP (``dist_model.py:251-288``): the area under the PR curve of a
    threshold swept over distances against human same/different labels;
    the 1e-12 guards give 0.0 where the reference divides 0 by 0."""
    ds: List[float] = []
    gts: List[float] = []
    for data in data_iter:
        ds += np.asarray(dist_fn(data["p0"], data["p1"])).reshape(-1).tolist()
        gts += np.asarray(data["same"]).reshape(-1).tolist()
    sames = np.array(gts)
    darr = np.array(ds)
    sames_sorted = sames[np.argsort(darr)]
    tps = np.cumsum(sames_sorted)
    fps = np.cumsum(1 - sames_sorted)
    fns = np.sum(sames_sorted) - tps
    precs = tps / np.maximum(tps + fps, 1e-12)
    recs = tps / np.maximum(tps + fns, 1e-12)
    return voc_ap(recs, precs), dict(ds=darr, sames=sames)
