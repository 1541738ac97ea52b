"""Vision functionals. Counterpart of ``paddle_tpu/nn/functional/vision.py``
(``affine_grid``, ``grid_sample``), the reference's gathers and lerps in
torch ops."""
import torch

__all__ = ['affine_grid', 'grid_sample']


def affine_grid(theta, out_shape, align_corners=True):
    """The (N, H, W, 2) sampling grid of the affine maps ``theta`` (N, 2,
    3) over an ``out_shape`` (N, C, H, W) output."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, h, w = (int(s) for s in out_shape)
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        xs, ys = torch.linspace(-1, 1, w, **kw), torch.linspace(-1, 1, h, **kw)
    else:
        xs = (torch.arange(w, **kw) * 2 + 1) / w - 1
        ys = (torch.arange(h, **kw) * 2 + 1) / h - 1
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum('hwk,nik->nhwi', base, theta)


def grid_sample(x, grid, mode='bilinear', padding_mode='zeros',
                align_corners=True):
    """Sample ``x`` (N, C, H, W) at ``grid`` (N, gh, gw, 2) in [-1, 1]:
    bilinear or nearest; outside the image zeros (``'zeros'``) or the
    border's value."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    bi = torch.arange(n, device=x.device)[:, None, None, None]
    ci = torch.arange(c, device=x.device)[None, :, None, None]

    def sample(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        cx, cy = torch.clamp(ix, 0, w - 1), torch.clamp(iy, 0, h - 1)
        out = x[bi, ci, cy[:, None], cx[:, None]]
        if padding_mode == 'zeros':
            out = out * inside[:, None].to(x.dtype)
        return out

    if mode == 'nearest':
        return sample(torch.round(fx).to(torch.int64),
                      torch.round(fy).to(torch.int64))
    x0, y0 = torch.floor(fx).to(torch.int64), torch.floor(fy).to(torch.int64)
    wx = (fx - x0).to(x.dtype)[:, None]
    wy = (fy - y0).to(x.dtype)[:, None]
    return ((1 - wy) * ((1 - wx) * sample(x0, y0) + wx * sample(x0 + 1, y0))
            + wy * ((1 - wx) * sample(x0, y0 + 1)
                    + wx * sample(x0 + 1, y0 + 1)))
