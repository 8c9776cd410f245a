"""Parametric 3D face model and coefficient regressor — the counterpart of
`pggan_tpu/models/face3d.py` (Deep3DFaceRecon, the reference's
`submodel/deep3dmm.py`).

  * `ParametricFaceModel` (`deep3dmm.py:14-289`): shape = mean + Bid·α +
    Bexp·β, texture = mean + Btex·δ, Euler rotation, camera and perspective
    projection, landmarks, vertex normals, 9-band spherical-harmonics
    shading, `compute_for_render` of the 257 coefficients. An `nn.Module`
    whose bases are buffers, built on `device` (the card unless asked
    otherwise).
  * `ReconNet` (`deep3dmm.py:509-539`): ResNet-50 + global average pool +
    seven zero-initialised 1×1 heads (use_last_fc=False), with the
    reference's keys (`backbone.*`, `final_layers.{i}`).

The BFM 2009 assets are not shipped (`transferBFM09`, `deep3dmm.py:562`):
the bases and the mesh topology (`face_buf` [F, 3], `point_buf` [V, K],
0-indexed, padded with F) are constructor arguments, with small synthetic
numpy-seeded defaults — the same draws as the JAX package's. With topology
the normals are the reference's gather algorithm, else the normalised
vertex direction.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pggan_tpu_torch.models.backbones import JaxArrays, ResNet, as_tensors, put_resnet

# 257-dim coefficient layout (`deep3dmm.py:240-261`).
COEFF_SPLIT = {"id": (0, 80), "exp": (80, 144), "tex": (144, 224),
               "angle": (224, 227), "gamma": (227, 254), "trans": (254, 257)}
# Per-coefficient head widths (`deep3dmm.py:517-525`): id, exp, tex, angle,
# gamma, (tx, ty), tz.
RECONNET_HEADS = (80, 64, 80, 3, 27, 2, 1)


def split_coeff(coeffs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[B, 257] → named groups."""
    return {k: coeffs[:, a:b] for k, (a, b) in COEFF_SPLIT.items()}


def build_point_buf(face_buf: np.ndarray, n_vertices: int) -> np.ndarray:
    """Vertex → adjacent-face table [V, K] from triangles [F, 3], rows padded
    with F (the zero row `compute_norm` appends) — a copy of the JAX
    package's (`face3d.py:48-63`)."""
    face_buf = np.asarray(face_buf)
    nf = face_buf.shape[0]
    adj = [[] for _ in range(n_vertices)]
    for f, tri in enumerate(face_buf):
        for vtx in tri:
            adj[int(vtx)].append(f)
    k = max(1, max(len(a) for a in adj))
    out = np.full((n_vertices, k), nf, dtype=np.int32)
    for vtx, faces in enumerate(adj):
        out[vtx, :len(faces)] = faces
    return out


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(|x|, 1e-12) over the last axis (F.normalize)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class ParametricFaceModel(nn.Module):
    def __init__(self, *, n_vertices: int = 1024, n_landmarks: int = 68,
                 bases: Optional[Mapping[str, np.ndarray]] = None,
                 focal: float = 1015.0, center: float = 112.0,
                 camera_distance: float = 10.0, seed: int = 0, device="cuda"):
        super().__init__()
        v = n_vertices
        if bases is None:
            rs = np.random.RandomState(seed)
            bases = {
                "mean_shape": rs.randn(v * 3).astype(np.float32) * 0.1,
                "id_base": rs.randn(v * 3, 80).astype(np.float32) * 0.01,
                "exp_base": rs.randn(v * 3, 64).astype(np.float32) * 0.01,
                "mean_tex": rs.rand(v * 3).astype(np.float32),
                "tex_base": rs.randn(v * 3, 80).astype(np.float32) * 0.01,
                "landmark_index": rs.choice(v, min(n_landmarks, v), replace=False
                                            ).astype(np.int32),
            }
        bases = dict(bases)
        face_buf, point_buf = bases.pop("face_buf", None), bases.pop("point_buf", None)
        if face_buf is not None and point_buf is None:
            point_buf = build_point_buf(face_buf, v)
        for name, value in bases.items():
            value = np.asarray(value)
            self.register_buffer(name, torch.from_numpy(
                value.astype(np.int64 if name == "landmark_index" else np.float32)))
        for name, value in (("face_buf", face_buf), ("point_buf", point_buf)):
            self.register_buffer(name, None if value is None else
                                 torch.from_numpy(np.asarray(value, np.int64)))
        self.n_vertices = v
        self.focal, self.center = focal, center
        self.camera_distance = camera_distance
        self.to(device)

    def compute_shape(self, id_coeff, exp_coeff):
        """mean + Bid·α + Bexp·β → [B, V, 3]."""
        s = self.mean_shape + id_coeff @ self.id_base.T + exp_coeff @ self.exp_base.T
        return s.reshape(id_coeff.shape[0], self.n_vertices, 3)

    def compute_texture(self, tex_coeff, normalize: bool = True):
        """mean + Btex·δ (/255 when `normalize`) → [B, V, 3]."""
        t = self.mean_tex + tex_coeff @ self.tex_base.T
        if normalize:
            t = t / 255.0
        return t.reshape(tex_coeff.shape[0], self.n_vertices, 3)

    @staticmethod
    def compute_rotation(angles):
        """Euler angles [B, 3] → (Rz·Ry·Rx)ᵀ [B, 3, 3] (`deep3dmm.py:165-198`)."""
        x, y, z = angles[:, 0], angles[:, 1], angles[:, 2]
        ones, zeros = torch.ones_like(x), torch.zeros_like(x)
        rx = torch.stack([ones, zeros, zeros, zeros, x.cos(), -x.sin(),
                          zeros, x.sin(), x.cos()], -1).reshape(-1, 3, 3)
        ry = torch.stack([y.cos(), zeros, y.sin(), zeros, ones, zeros,
                          -y.sin(), zeros, y.cos()], -1).reshape(-1, 3, 3)
        rz = torch.stack([z.cos(), -z.sin(), zeros, z.sin(), z.cos(), zeros,
                          zeros, zeros, ones], -1).reshape(-1, 3, 3)
        return (rz @ ry @ rx).transpose(1, 2)

    @staticmethod
    def transform(shape, rot, trans):
        return shape @ rot + trans[:, None, :]

    def to_camera(self, shape):
        """z → camera_distance − z."""
        return torch.cat([shape[..., :2], self.camera_distance - shape[..., 2:]], dim=-1)

    def to_image(self, shape):
        """Perspective projection → [B, V, 2]."""
        return shape[..., :2] * self.focal / shape[..., 2:3] + self.center

    def get_landmarks(self, proj):
        return proj[:, self.landmark_index]

    def compute_norm(self, shape):
        """Unit vertex normals [B, V, 3]: with topology, per-face normals
        cross(v1 − v2, v2 − v3) normalised, a zero row appended at index F,
        the adjacent faces' normals summed per vertex through point_buf and
        normalised (`deep3dmm.py:110-130`); without it, shape ·
        rsqrt(|shape|² + 1e-8)."""
        if self.face_buf is None:
            return shape * torch.rsqrt(shape.square().sum(-1, keepdim=True) + 1e-8)
        v1, v2, v3 = (shape[:, self.face_buf[:, i]] for i in range(3))
        face_norm = _normalize(torch.linalg.cross(v1 - v2, v2 - v3, dim=-1))
        face_norm = F.pad(face_norm, (0, 0, 0, 1))
        return _normalize(face_norm[:, self.point_buf].sum(dim=2))

    @staticmethod
    def compute_color(texture, norm, gamma):
        """9-band SH shading of the texture; gamma [B, 27] per channel, +0.8
        on each channel's DC term (`deep3dmm.py:132-163`)."""
        g = gamma.reshape(gamma.shape[0], 3, 9)
        g = torch.cat([g[..., :1] + 0.8, g[..., 1:]], dim=-1)
        a = [math.pi, 2 * math.pi / math.sqrt(3.0), 2 * math.pi / math.sqrt(8.0)]
        c = [1 / math.sqrt(4 * math.pi), math.sqrt(3.0) / math.sqrt(4 * math.pi),
             3 * math.sqrt(5.0) / math.sqrt(12 * math.pi)]
        nx, ny, nz = norm[..., 0], norm[..., 1], norm[..., 2]
        sh = torch.stack([
            a[0] * c[0] * torch.ones_like(nx),
            -a[1] * c[1] * ny, a[1] * c[1] * nz, -a[1] * c[1] * nx,
            a[2] * c[2] * nx * ny, -a[2] * c[2] * ny * nz,
            0.5 * a[2] * c[2] / math.sqrt(3.0) * (3 * nz.square() - 1),
            -a[2] * c[2] * nx * nz,
            0.5 * a[2] * c[2] * (nx.square() - ny.square()),
        ], dim=-1)                                          # [B, V, 9]
        return texture * torch.einsum("bvk,bck->bvc", sh, g)

    def compute_for_render(self, coeffs) -> Dict[str, torch.Tensor]:
        """[B, 257] → posed camera-frame vertices, projection, landmarks and
        shaded colour."""
        c = split_coeff(coeffs)
        shape = self.compute_shape(c["id"], c["exp"])
        rot = self.compute_rotation(c["angle"])
        cam = self.to_camera(self.transform(shape, rot, c["trans"]))
        proj = self.to_image(cam)
        color = self.compute_color(self.compute_texture(c["tex"]),
                                   self.compute_norm(shape) @ rot, c["gamma"])
        return {"vertices": cam, "projection": proj,
                "landmarks": self.get_landmarks(proj), "color": color}

    forward = compute_for_render


class ReconNet(nn.Module):
    """Face crop [B, 3, H, W] → [B, 257] coefficients (id | exp | tex | angle
    | gamma | tx, ty | tz)."""

    def __init__(self, *, seed: int = 0):
        super().__init__()
        self.backbone = ResNet(50, seed=seed)
        self.final_layers = nn.ModuleList(nn.utils.skip_init(nn.Conv2d, 2048, d, 1)
                                          for d in RECONNET_HEADS)
        with torch.no_grad():
            for head in self.final_layers:
                head.weight.zero_()
                head.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.backbone(x).mean(dim=(2, 3), keepdim=True)
        return torch.cat([head(feat).flatten(1) for head in self.final_layers], dim=1)


def convert_reconnet_state_dict(sd: Mapping) -> ReconNet:
    """A reference `ReconNet().state_dict()` (use_last_fc=False) loaded
    strictly."""
    module = ReconNet()
    module.load_state_dict(as_tensors(sd), strict=True)
    return module


def reconnet_params_from_jax(arrays: Mapping[str, np.ndarray]) -> ReconNet:
    """A `ReconNet` with the weights of JAX `init_reconnet` arrays."""
    jx = JaxArrays(arrays)
    put_resnet(jx, 50, key="backbone.", path="backbone/")
    for i in range(len(RECONNET_HEADS)):
        jx.matrix(f"final_layers.{i}", f"heads/{i}", bias=True, as_1x1=True)
    return jx.load(ReconNet())
