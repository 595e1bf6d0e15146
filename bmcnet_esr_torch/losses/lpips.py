"""LPIPS perceptual distance over the reference's whole option surface.

Counterpart of ``bmcnet_esr_tpu/losses/lpips.py`` (reference
PerceptualSimilarity ``PNetLin``, ``networks_basic.py:31-101``):

* :class:`LPIPS`: backbones ``alex`` / ``vgg`` (``vgg16``) / ``squeeze``
  (5/5/7 feature taps), ``version`` 0.1 (input scaling layer) or 0.0 (none,
  the original release), scalar or ``spatial`` distance maps (upsampled to
  the input height with ``nn.Upsample`` scale-factor semantics), learned
  heads (net-lin) or the plain ``net`` mode (channel sums), ``ret_per_layer``;
* the backbones are ``nn.Module`` stacks in torchvision's layout and names
  (``features.{i}.weight``, squeezenet's ``Fire``), since torchvision is
  not a dependency: a torchvision state dict loads as it is;
* :meth:`LPIPS.to_npz` / :meth:`LPIPS.from_npz` write and read the JAX
  package's bundle (``meta/*``, ``backbone/*``, ``lin/i``): a bundle written
  by either package loads in the other;
* :func:`resnet_features` (resnet 18/34/50/101/152 taps),
  :class:`DistanceModel` and :func:`perceptual_loss` (count images broadcast
  per channel, ``loss/restore.py:12-41``).

The weights are frozen: no parameter of an :class:`LPIPS` asks for a
gradient, so a recipe's LPIPS term adds nothing to the model's optimizer or
checkpoint.  Inputs narrower than float32 are widened to it and every
product runs in strict float32, as the JAX package's ``Precision.HIGHEST``
convolutions do; a bf16 model's prediction meets the term in float32, as
there.  A float64 copy (``.double()``) computes in float64.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512,
            "M"]
# (first, end) feature indices of each tap, and the taps' channels
_NETS = {
    "alex": ([(0, 2), (2, 5), (5, 8), (8, 10), (10, 12)], [64, 192, 384, 256, 256]),
    "vgg": ([(0, 4), (4, 9), (9, 16), (16, 23), (23, 30)], [64, 128, 256, 512, 512]),
    "squeeze": ([(0, 2), (2, 5), (5, 8), (8, 10), (10, 11), (11, 12), (12, 13)],
                [64, 128, 256, 384, 384, 512, 512]),
}
_NETS["vgg16"] = _NETS["vgg"]


class Fire(nn.Module):
    """torchvision's squeezenet ``Fire`` (same parameter names)."""

    def __init__(self, inplanes: int, squeeze: int, expand1x1: int, expand3x3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(inplanes, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand1x1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand3x3, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)), F.relu(self.expand3x3(x))], 1)


def _features(net: str) -> nn.Sequential:
    """torchvision's ``<net>.features`` stack, up to the last tap."""
    if net == "alex":
        return nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(),
        )
    if net in ("vgg", "vgg16"):
        layers: List[nn.Module] = []
        c = 3
        for v in _VGG_CFG[:-1]:  # the last pool is past the last tap
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c, v, 3, 1, 1), nn.ReLU()]
                c = v
        return nn.Sequential(*layers)
    if net == "squeeze":  # squeezenet1_1, ceil-mode pools
        return nn.Sequential(
            nn.Conv2d(3, 64, 3, 2), nn.ReLU(), nn.MaxPool2d(3, 2, ceil_mode=True),
            Fire(64, 16, 64, 64), Fire(128, 16, 64, 64), nn.MaxPool2d(3, 2, ceil_mode=True),
            Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
            nn.MaxPool2d(3, 2, ceil_mode=True),
            Fire(256, 48, 192, 192), Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
            Fire(512, 64, 256, 256),
        )
    raise ValueError(f"unknown LPIPS net {net!r}: choose alex, vgg, vgg16 or squeeze")


def _as_tensor(v) -> Tensor:
    return torch.as_tensor(np.array(v, np.float32))


def convert_backbone_state_dict(state: Dict, net: str = "alex") -> Dict[str, Tensor]:
    """A ``<net>.features`` state dict -> the backbone's (``{i}.weight``,
    ``{i}.bias``, Fire's ``{i}.{squeeze,expand1x1,expand3x3}.*``).  Bare
    ``{i}.*`` keys, ``features.{i}.*`` and the reference's ``slice{n}.{i}.*``
    are accepted; a missing parameter raises."""
    pat = re.compile(r"(\d+)\.(?:(squeeze|expand1x1|expand3x3)\.)?(weight|bias)$")
    norm = {}
    for key, value in state.items():
        m = pat.search(key)
        if m:
            idx, part, leaf = m.groups()
            norm[f"{idx}.{part}.{leaf}" if part else f"{idx}.{leaf}"] = value
    out = {}
    for key in _features(net).state_dict():
        if key not in norm:
            raise KeyError(f"missing backbone param features.{key}")
        out[key] = _as_tensor(norm[key])
    return out


def load_lin_weights(path: str, net: str = "alex") -> List[Tensor]:
    """The reference's linear heads (``weights/v{0.0,0.1}/{net}.pth``:
    ``lin{k}.model.1.weight`` ``[1, C, 1, 1]``) -> ``[1, C]`` each."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return [state[f"lin{k}.model.1.weight"][:, :, 0, 0].float().clone()
            for k in range(len(_NETS[net][1]))]


def _unit_normalize(feat: Tensor, eps: float = 1e-10) -> Tensor:
    return feat / (torch.sqrt(torch.sum(feat**2, dim=1, keepdim=True)) + eps)


def _upsample(x: Tensor, out_h: int) -> Tensor:
    """``nn.Upsample(scale_factor=out_H / in_H, mode='bilinear',
    align_corners=False)`` (``networks_basic.py:25-29``): both axes take the
    height's factor."""
    return F.interpolate(x, scale_factor=out_h / x.shape[2], mode="bilinear",
                         align_corners=False)


class LPIPS(nn.Module):
    """``PNetLin`` distance.

    Args:
      backbone_params: the backbone's weights by torchvision name
        (:func:`convert_backbone_state_dict`).
      lin_weights: the learned heads, ``[1, C]`` each (None in plain mode).
      net: ``alex`` | ``vgg`` / ``vgg16`` | ``squeeze``.
      version: ``"0.1"`` (input scaling) or ``"0.0"`` (none).
      spatial: per-pixel distance maps instead of spatial means.
      lpips: learned heads (net-lin) or channel sums (the plain ``net``).
    """

    def __init__(self, backbone_params: Dict, lin_weights: Optional[Sequence] = None,
                 net: str = "alex", *, version: str = "0.1", spatial: bool = False,
                 lpips: bool = True):
        super().__init__()
        self.net_name = net
        self.version = version
        self.spatial = spatial
        self.lpips = lpips
        slices, chns = _NETS[net]
        if lpips and lin_weights is None:
            raise ValueError("net-lin mode needs lin_weights (or pass lpips=False)")
        if lpips and len(lin_weights) != len(chns):
            raise ValueError(f"{net} needs {len(chns)} lin heads, got {len(lin_weights)}")
        self.slices = slices
        self.net = _features(net)
        self.net.load_state_dict({k: _as_tensor(v) for k, v in backbone_params.items()})
        self.n_lins = len(lin_weights) if lin_weights is not None else 0
        for k in range(self.n_lins):
            self.register_buffer(f"lin{k}", _as_tensor(lin_weights[k]).reshape(1, -1))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None])
        self.requires_grad_(False)
        self.eval()

    @property
    def lins(self) -> Optional[List[Tensor]]:
        return [getattr(self, f"lin{k}") for k in range(self.n_lins)] if self.lpips else None

    @property
    def backbone(self) -> Dict[str, Tensor]:
        return dict(self.net.state_dict())

    @classmethod
    def from_torch(cls, backbone_state_dict: Dict, lin_weights_path: Optional[str] = None,
                   net: str = "alex", **kwargs) -> "LPIPS":
        lins = load_lin_weights(lin_weights_path, net) if lin_weights_path else None
        return cls(convert_backbone_state_dict(backbone_state_dict, net), lins, net, **kwargs)

    def to_npz(self, path: str) -> str:
        """Write the JAX package's bundle (``bmcnet_esr_tpu/losses/lpips.py``
        ``LPIPS.to_npz``)."""
        data: Dict[str, np.ndarray] = {
            "meta/net": np.asarray(self.net_name),
            "meta/version": np.asarray(self.version),
            "meta/lpips": np.asarray(int(self.lpips)),
        }
        for k, v in self.backbone.items():
            data[f"backbone/{k}"] = v.detach().cpu().numpy()
        for i, lin in enumerate(self.lins or ()):
            data[f"lin/{i}"] = lin.detach().cpu().numpy()
        np.savez_compressed(path, **data)
        return path

    @classmethod
    def from_npz(cls, path: str, **kwargs) -> "LPIPS":
        """Read a bundle written by either package's ``to_npz``."""
        with np.load(path) as z:
            net = str(z["meta/net"])
            kwargs.setdefault("version", str(z["meta/version"]))
            kwargs.setdefault("lpips", bool(int(z["meta/lpips"])))
            backbone = {k[len("backbone/"):]: z[k] for k in z.files if k.startswith("backbone/")}
            lin_keys = sorted((k for k in z.files if k.startswith("lin/")),
                              key=lambda k: int(k.split("/")[1]))
            lins = [z[k] for k in lin_keys] or None
        return cls(backbone, lins, net, **kwargs)

    def features(self, x: Tensor) -> List[Tensor]:
        """The backbone's taps (5, or 7 for squeeze)."""
        outs = []
        for start, end in self.slices:
            for i in range(start, end):
                x = self.net[i](x)
            outs.append(x)
        return outs

    def forward(self, in0: Tensor, in1: Tensor, ret_per_layer: bool = False,
                drop_masks: Optional[Sequence[Tensor]] = None,
                lins: Optional[Sequence[Tensor]] = None):
        """``[B, 3, H, W]`` inputs in [-1, 1] -> ``[B, 1, 1, 1]`` distances
        (``[B, 1, H, W]`` maps when ``spatial``).  ``drop_masks`` (0 or
        1/(1-p), one per tap) multiply the squared differences before the
        heads: the training path's dropout.  ``lins`` replace the heads
        (:class:`LPIPSTrainer`'s trainable copies)."""
        wide = torch.promote_types(in0.dtype, torch.float32)  # bf16 -> float32
        x0, x1 = in0.to(wide), in1.to(wide)
        if self.version == "0.1":
            x0 = (x0 - self.shift) / self.scale
            x1 = (x1 - self.shift) / self.scale
        lins = self.lins if lins is None else lins
        res = []
        for k, (a, b) in enumerate(zip(self.features(x0), self.features(x1))):
            diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            if drop_masks is not None:
                diff = diff * drop_masks[k]
            if self.lpips:
                head = torch.einsum("oc,bchw->bohw", lins[k], diff)
            else:
                head = torch.sum(diff, dim=1, keepdim=True)
            if self.spatial:
                res.append(_upsample(head, int(in0.shape[2])))
            else:
                res.append(torch.mean(head, dim=(2, 3), keepdim=True))
        val = res[0]
        for r in res[1:]:
            val = val + r
        if ret_per_layer:
            return val, res
        return val


# -- resnet feature extractors (pretrained_networks.py:139-181) --------------

class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


_RESNET_BLOCKS = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (Bottleneck, [3, 4, 6, 3]),
    101: (Bottleneck, [3, 4, 23, 3]),
    152: (Bottleneck, [3, 8, 36, 3]),
}


class ResNetFeatures(nn.Module):
    """torchvision's ResNet without its classifier (same names), evaluated
    with the BatchNorm running statistics; ``forward`` returns the
    reference extractor's 5 taps (relu1, layer1..4)."""

    def __init__(self, num: int = 18):
        super().__init__()
        block, layers = _RESNET_BLOCKS[num]
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            setattr(self, f"layer{i}", self._make_layer(block, planes, blocks, 1 if i == 1 else 2))
        self.requires_grad_(False)
        self.eval()

    def _make_layer(self, block, planes: int, blocks: int, stride: int) -> nn.Sequential:
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, 1, stride, bias=False),
                nn.BatchNorm2d(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        layers += [block(self.inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x: Tensor) -> List[Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        taps = [h]
        h = F.max_pool2d(h, 3, 2, 1)
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
            taps.append(h)
        return taps


def convert_resnet_state_dict(state: Dict) -> Dict[str, Tensor]:
    """A torchvision resnet state dict without ``num_batches_tracked`` and
    the classifier (``fc.*``)."""
    return {k: _as_tensor(v) for k, v in state.items()
            if not k.endswith("num_batches_tracked") and not k.startswith("fc.")}


def resnet_features(params: Dict, x: Tensor, num: int = 18) -> List[Tensor]:
    """The reference resnet extractor's 5 taps (``pretrained_networks.py:
    163-181``) under ``params`` (:func:`convert_resnet_state_dict`)."""
    net = ResNetFeatures(num)
    missing, unexpected = net.load_state_dict({k: _as_tensor(v) for k, v in params.items()},
                                              strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"resnet{num} params: missing {missing}, unexpected {unexpected}")
    return net.to(x.device)(x.float())


# -- the FakeNet distance modes (dist_model.py:81-86) -------------------------

def l2_distance(in0: Tensor, in1: Tensor) -> Tensor:
    """``DistModel(model='L2', colorspace='RGB')``: the mean squared
    difference of each image pair (``networks_basic.py:163-167``)."""
    return torch.mean(torch.square(in0 - in1), dim=(1, 2, 3))


def _tensor2im_quantize(x: Tensor) -> Tensor:
    """The reference's ``tensor2im``: [-1, 1] -> [0, 255], truncated."""
    return torch.clamp(torch.floor((x + 1.0) * 127.5), 0.0, 255.0)


def dssim_distance(in0: Tensor, in1: Tensor) -> Tensor:
    """``DistModel(model='SSIM', colorspace='RGB')``: ``(1 - SSIM) / 2`` on
    uint8-quantized images, data range 255, SSIM averaged over channels."""
    from bmcnet_esr_torch.losses.restore import ssim_metric

    q0, q1 = _tensor2im_quantize(in0), _tensor2im_quantize(in1)
    return torch.stack([(1.0 - ssim_metric(q0[b], q1[b], 255.0)) / 2.0
                        for b in range(in0.shape[0])])


class DistanceModel:
    """``DistModel.initialize``'s dispatch (``dist_model.py:28-113``):
    ``model`` net-lin, net, L2 or SSIM/DSSIM.  Weights are explicit inputs;
    nothing is downloaded."""

    def __init__(self, model: str = "net-lin", net: str = "alex", *,
                 backbone_state_dict: Optional[Dict] = None,
                 lin_weights_path: Optional[str] = None, version: str = "0.1",
                 spatial: bool = False):
        self.model = model
        self.name = f"{model} [{net}]"
        if model == "net-lin":
            self._fn = LPIPS.from_torch(backbone_state_dict, lin_weights_path, net,
                                        version=version, spatial=spatial, lpips=True)
        elif model == "net":
            self._fn = LPIPS.from_torch(backbone_state_dict, None, net, version=version,
                                        spatial=spatial, lpips=False)
        elif model in ("L2", "l2"):
            self._fn = l2_distance
            self.name = "L2"
        elif model in ("DSSIM", "dssim", "SSIM", "ssim"):
            self._fn = dssim_distance
            self.name = "SSIM"
        else:
            raise ValueError(f"Model [{model}] not recognized.")

    def __call__(self, in0: Tensor, in1: Tensor, ret_per_layer: bool = False):
        if isinstance(self._fn, LPIPS):
            return self._fn(in0, in1, ret_per_layer)
        return self._fn(in0, in1)

    forward = __call__


def perceptual_loss(lpips: LPIPS, pred: Tensor, target: Tensor, *, normalize: bool = True,
                    weight: float = 1.0) -> Tensor:
    """The reference wrapper (``loss/restore.py:12-41``): inputs in [0, 1]
    (``normalize``) map to [-1, 1]; one channel is repeated to three, three
    pass as they are, and any other count is averaged over its channels,
    each repeated to three (count images: two)."""
    if normalize:
        pred = 2.0 * pred - 1.0
        target = 2.0 * target - 1.0
    c = pred.shape[1]
    if c == 1:
        dist = lpips(torch.cat([pred] * 3, dim=1), torch.cat([target] * 3, dim=1))
    elif c == 3:
        dist = lpips(pred, target)
    else:
        dist = 0.0
        for idx in range(c):
            dist = dist + lpips(pred[:, idx:idx + 1].repeat(1, 3, 1, 1),
                                target[:, idx:idx + 1].repeat(1, 3, 1, 1))
        dist = dist / c
    return weight * torch.mean(dist)
