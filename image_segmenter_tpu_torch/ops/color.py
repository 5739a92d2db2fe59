"""sRGB <-> LAB / HSV / gray colour-space conversions.

Counterpart of image_segmenter_tpu/ops/color.py: the conversions the
reference delegates to skimage (rgb2lab / lab2rgb) and OpenCV (RGB2HSV,
RGB2LAB, RGB2GRAY). All functions are elementwise chains over arrays of
shape (..., 3).

Two LAB variants, as in the JAX package: `srgb_to_lab` / `lab_to_srgb`
are skimage's (D65, L in [0, 100], a and b roughly [-128, 127]);
`rgb_u8_to_lab_cv` is OpenCV's 8-bit scaling of the same colorimetry.

Rounding. The sRGB gamma (a power of 2.4) and the LAB cube root have no
float32 form that rounds the same in XLA, in PyTorch on the CPU and in
CUDA's powf (and there is no torch.cbrt), so both are taken in float64
and rounded to float32 once: the result is the correctly rounded float32
value but for rare double-rounding cases, on every device. The 3 x 3
matrix products stay elementwise in the written order, and divisions by a
constant are true divisions (utils/backend.true_div).

Packed colours are int64 (torch sorts and searches no uint32), so
`SENTINEL` 0xFFFFFFFF still sorts after every packed RGB or RGBA key.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.utils.backend import true_div

# sRGB -> XYZ matrix (IEC 61966-2-1, D65), rows X/Y/Z, as float32 values.
_RGB2XYZ = (
    (0.412456439089692, 0.357576077643909, 0.180437483266399),
    (0.212672851405623, 0.715152155287818, 0.072174993306560),
    (0.019333895582329, 0.119192025881303, 0.950304078536368),
)
_XYZ2RGB = (
    (3.240454162114103, -1.537138512797715, -0.498531409556016),
    (-0.969266030505187, 1.876010845446694, 0.041556017530349),
    (0.055643430959114, -0.204025913516754, 1.057225188223179),
)
# D65 reference white (2-degree observer), as used by skimage.
_D65 = (0.95047, 1.0, 1.08883)

_EPS = 216.0 / 24389.0  # (6/29)^3
_KAPPA = 24389.0 / 27.0  # (29/3)^3


def _pow64(x: torch.Tensor, p: float) -> torch.Tensor:
    """x ** p taken in float64 and rounded to float32 once."""
    return torch.pow(x.to(torch.float64), p).to(torch.float32)


def srgb_linearize(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB electro-optical transfer: gamma-encoded [0,1] -> linear [0,1]."""
    srgb = srgb.to(torch.float32)
    return torch.where(
        srgb <= 0.04045,
        true_div(srgb, 12.92),
        _pow64(true_div(srgb + 0.055, 1.055), 2.4),
    )


def srgb_delinearize(lin: torch.Tensor) -> torch.Tensor:
    """Linear [0,1] -> gamma-encoded sRGB [0,1]."""
    lin = lin.to(torch.float32)
    safe = torch.clamp_min(lin, 1e-12)
    return torch.where(
        lin <= 0.0031308,
        lin * 12.92,
        1.055 * _pow64(safe, 1.0 / 2.4) - 0.055,
    )


def _mat3(v: torch.Tensor, m) -> torch.Tensor:
    """Apply a 3x3 matrix to (..., 3) by elementwise multiply-adds in the
    written order (never a matmul: the same float32 bits on every device)."""
    c0, c1, c2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            m[0][0] * c0 + m[0][1] * c1 + m[0][2] * c2,
            m[1][0] * c0 + m[1][1] * c1 + m[1][2] * c2,
            m[2][0] * c0 + m[2][1] * c1 + m[2][2] * c2,
        ],
        dim=-1,
    )


def _d65(t: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_D65, dtype=torch.float32, device=t.device)


def srgb_to_xyz(srgb: torch.Tensor) -> torch.Tensor:
    return _mat3(srgb_linearize(srgb), _RGB2XYZ)


def xyz_to_srgb(xyz: torch.Tensor) -> torch.Tensor:
    lin = _mat3(xyz.to(torch.float32), _XYZ2RGB)
    return srgb_delinearize(torch.clamp(lin, 0.0, 1.0))


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    cbrt = _pow64(torch.clamp_min(t, 0.0), 1.0 / 3.0)
    return torch.where(t > _EPS, cbrt, true_div(_KAPPA * t + 16.0, 116.0))


def _lab_finv(f: torch.Tensor) -> torch.Tensor:
    f3 = f * f * f
    return torch.where(f3 > _EPS, f3, true_div(116.0 * f - 16.0, _KAPPA))


def srgb_to_lab(srgb: torch.Tensor) -> torch.Tensor:
    """skimage-compatible rgb2lab. Input (..., 3) float in [0,1]; output
    float32, L in [0,100], a/b approximately [-128,127]."""
    xyz = srgb_to_xyz(srgb)
    f = _lab_f(xyz / _d65(xyz))
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=-1)


def lab_to_srgb(lab: torch.Tensor) -> torch.Tensor:
    """skimage-compatible lab2rgb. Output float32 in [0,1] (clipped)."""
    lab = lab.to(torch.float32)
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = true_div(L + 16.0, 116.0)
    fx = fy + true_div(a, 500.0)
    fz = fy - true_div(b, 200.0)
    xyz = torch.stack([_lab_finv(fx), _lab_finv(fy), _lab_finv(fz)], dim=-1)
    return torch.clamp(xyz_to_srgb(xyz * _d65(xyz)), 0.0, 1.0)


def rgb_u8_to_lab(rgb_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB -> skimage-style float LAB."""
    return srgb_to_lab(true_div(rgb_u8.to(torch.float32), 255.0))


def lab_to_rgb_u8(lab: torch.Tensor) -> torch.Tensor:
    """skimage-style float LAB -> uint8 RGB (round half to even, as
    jnp.round)."""
    srgb = lab_to_srgb(lab)
    return torch.clamp(torch.round(srgb * 255.0), 0, 255).to(torch.uint8)


def rgb_u8_to_lab_cv(rgb_u8: torch.Tensor) -> torch.Tensor:
    """OpenCV 8-bit COLOR_RGB2LAB-compatible conversion (float32 output):
    L * 255/100, a + 128, b + 128; round and cast to compare with cv2."""
    lab = rgb_u8_to_lab(rgb_u8)
    L = lab[..., 0] * (255.0 / 100.0)
    a = lab[..., 1] + 128.0
    b = lab[..., 2] + 128.0
    return torch.stack([L, a, b], dim=-1)


def rgb_u8_to_hsv_cv(rgb_u8: torch.Tensor) -> torch.Tensor:
    """OpenCV 8-bit COLOR_RGB2HSV-compatible conversion -> float32 (..., 3):
    H in [0,180) (degrees / 2), S and V in [0,255]."""
    rgb = rgb_u8.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c == 0, 1.0, c)
    # Hue in degrees
    h_r = 60.0 * (g - b) / safe_c
    h_g = 120.0 + 60.0 * (b - r) / safe_c
    h_b = 240.0 + 60.0 * (r - g) / safe_c
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b))
    h = torch.where(c == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h) * 0.5  # OpenCV stores H/2 for uint8
    s = torch.where(v == 0, 0.0, 255.0 * c / torch.where(v == 0, 1.0, v))
    return torch.stack([h, s, v], dim=-1)


def hsv_cv_to_rgb_u8(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_u8_to_hsv_cv. hsv float32 (H in [0,180), S/V in
    [0,255])."""
    h = hsv[..., 0] * 2.0  # degrees
    s = true_div(hsv[..., 1], 255.0)
    v = hsv[..., 2]
    c = v * s
    hp = true_div(h, 60.0)
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    idx = torch.clamp(hp.to(torch.int32), 0, 5)

    def select(choices):
        out = choices[5]
        for i in range(4, -1, -1):
            out = torch.where(idx == i, choices[i], out)
        return out

    r1 = select([c, x, z, z, x, c])
    g1 = select([x, c, c, x, z, z])
    b1 = select([z, z, x, c, c, x])
    m = v - c
    rgb = torch.stack([r1 + m, g1 + m, b1 + m], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def rgb_u8_to_gray_cv(rgb_u8: torch.Tensor) -> torch.Tensor:
    """OpenCV COLOR_RGB2GRAY: Y = 0.299 R + 0.587 G + 0.114 B, rounded u8."""
    rgb = rgb_u8.to(torch.float32)
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def pack_rgb_u32(rgb_u8: torch.Tensor) -> torch.Tensor:
    """Pack (..., 3) uint8 RGB into (...,) keys r<<16 | g<<8 | b (int64)."""
    c = rgb_u8.to(torch.int64)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def unpack_rgb_u32(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_rgb_u32: (...,) keys -> (..., 3) uint8."""
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)
