"""Headless software mirror of the WebGL viewer page.

Counterpart of the JAX package's ``utils/viewer_softrender.py``. A compute
host often has no browser or JS engine, so the page's GL pipeline cannot be
driven end-to-end there. This module
re-implements the page's EXACT render path in numpy — same ``/scene.bin``
section parser, same orbit camera (z-up lookAt, fovy π/3, default
target/az/el/dist), same flat-shaded mesh lighting, same size-attenuated
round point sprites, same clear color — against a z-buffer, so the served
scene can be rendered to a PNG and pixel-checksummed in CI. Constants are
cross-checked against the page source (viewer_server._PAGE); any drift
between the two pipelines is a bug in one of them.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 0x54534C56

CLEAR = np.array([0.063, 0.075, 0.102], np.float32)   # page clearColor
LIGHT = np.array([0.35, 0.5, 0.8]) / np.linalg.norm([0.35, 0.5, 0.8])
GRID_COL = 0x1D2435
AXES = [(0x883333, (1, 0, 0)), (0x338833, (0, 1, 0)), (0x333388, (0, 0, 1))]
TRIAD = [0xFF5555, 0x55FF66, 0x5588FF]
TRAJ_COL = 0x4AA3FF
SKEL_COL = 0x39D98A
LINES_COL = 0x888888
DEF_PT_COL = (0.29, 0.64, 1.0)
DEF_MESH_COL = (0.53, 0.67, 0.6)


def _hex(c):
    return np.array([(c >> 16 & 255) / 255, (c >> 8 & 255) / 255,
                     (c & 255) / 255], np.float32)


class Scene:
    def __init__(self):
        self.version = -1
        self.par = None
        self.par_col = None
        self.mesh = None
        self.mesh_col = None
        self.lines = []        # (xyz (N,3), color (3,))
        self.radius = 0.025
        # page's static helpers: ground grid + axes
        seg = []
        for i in range(-10, 11):
            seg += [i, -10, 0, i, 10, 0, -10, i, 0, 10, i, 0]
        self.static_lines = [
            (np.asarray(seg, np.float32).reshape(-1, 3), _hex(GRID_COL))]
        for c, d in AXES:
            self.static_lines.append((np.array(
                [[0, 0, 0], [d[0] * .5, d[1] * .5, d[2] * .5]], np.float32),
                _hex(c)))


def parse_scene(blob: bytes) -> Scene:
    """Mirror of the page's parse() (viewer_server._PAGE)."""
    s = Scene()
    magic, version = struct.unpack_from("<II", blob, 0)
    assert magic == _MAGIC, hex(magic)
    s.version = version
    off = 8
    while off + 8 <= len(blob):
        tag, ln = struct.unpack_from("<II", blob, off)
        off += 8
        f = np.frombuffer(blob[off:off + ln], np.float32)
        off += ln
        if tag == 1:
            s.par = f.reshape(-1, 3)
        elif tag == 2:
            s.par_col = f.reshape(-1, 3)
        elif tag == 3:
            s.mesh = f.reshape(-1, 3)
        elif tag == 4:
            s.mesh_col = f.reshape(-1, 3)
        elif tag == 5:
            s.lines.append((f.reshape(-1, 3), _hex(LINES_COL)))
        elif tag == 6:
            s.lines.append((f.reshape(-1, 3), _hex(SKEL_COL)))
        elif tag == 7:
            R = f[1:10].reshape(3, 3)
            T = f[10:13]
            for a in range(3):
                tip = T + R[:, a] * 0.3
                s.lines.append((np.stack([T, tip]), _hex(TRIAD[a])))
        elif tag == 8:
            n = int(f[1])
            pts = f[2:2 + n * 3].reshape(-1, 3)
            if n > 1:
                seg = np.empty((2 * (n - 1), 3), np.float32)
                seg[0::2] = pts[:-1]
                seg[1::2] = pts[1:]
                s.lines.append((seg, _hex(TRAJ_COL)))
        elif tag == 9:
            s.radius = float(f[0])
    return s


def _persp(fovy, aspect, near, far):
    f = 1.0 / np.tan(fovy / 2)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def _look_at(eye, tgt, up):
    z = eye - tgt
    z = z / (np.linalg.norm(z) or 1)
    x = np.cross(up, z)
    x = x / (np.linalg.norm(x) or 1)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = x, y, z
    m[:3, 3] = [-x @ eye, -y @ eye, -z @ eye]
    return m


def render(scene: Scene, w=800, h=600, target=(0, 0, 0.5), az=0.8, el=0.5,
           dist=6.0, disp_particles=True, disp_mesh=True):
    """Rasterize like the page's draw(): returns (h, w, 3) float32 RGB."""
    target = np.asarray(target, np.float32)
    eye = target + dist * np.array([np.cos(el) * np.cos(az),
                                    np.cos(el) * np.sin(az),
                                    np.sin(el)], np.float32)
    mvp = _persp(np.pi / 3, w / h, 0.01, 500.0) @ \
        _look_at(eye, target, np.array([0, 0, 1.0]))

    img = np.tile(CLEAR, (h, w, 1)).astype(np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)

    def project(xyz):
        p = np.concatenate([xyz, np.ones((len(xyz), 1), np.float32)], 1)
        clip = p @ mvp.T
        wc = clip[:, 3]
        ok = wc > 0.01
        ndc = clip[:, :3] / np.maximum(wc[:, None], 1e-9)
        sx = (ndc[:, 0] * 0.5 + 0.5) * w
        sy = (0.5 - ndc[:, 1] * 0.5) * h
        return sx, sy, ndc[:, 2], wc, ok

    def put(xi, yi, z, col):
        m = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi, yi, z = xi[m], yi[m], z[m]
        col = col[m] if col.ndim == 2 else col
        order = np.argsort(-z)   # far first; near overwrites
        xi, yi, z = xi[order], yi[order], z[order]
        col = col[order] if col.ndim == 2 else col
        win = z <= zbuf[yi, xi]
        xi, yi, z = xi[win], yi[win], z[win]
        zbuf[yi, xi] = z
        img[yi, xi] = col[win] if col.ndim == 2 else col

    # lines (page draws them first)
    for xyz, col in scene.static_lines + scene.lines:
        if len(xyz) < 2:
            continue
        sx, sy, sz, wc, ok = project(xyz)
        for a in range(0, len(xyz) - 1, 2):
            if not (ok[a] and ok[a + 1]):
                continue
            n = int(max(abs(sx[a + 1] - sx[a]), abs(sy[a + 1] - sy[a]))) + 1
            n = min(n, 4 * max(w, h))
            t = np.linspace(0, 1, n)
            put((sx[a] + (sx[a + 1] - sx[a]) * t).astype(int),
                (sy[a] + (sy[a + 1] - sy[a]) * t).astype(int),
                sz[a] + (sz[a + 1] - sz[a]) * t, col)

    # mesh: flat-shaded triangles (page's progMesh)
    if disp_mesh and scene.mesh is not None and len(scene.mesh) >= 3:
        v = scene.mesh
        col = scene.mesh_col if scene.mesh_col is not None else \
            np.tile(np.asarray(DEF_MESH_COL, np.float32), (len(v), 1))
        sx, sy, sz, wc, ok = project(v)
        for t0 in range(0, len(v) - 2, 3):
            i0, i1, i2 = t0, t0 + 1, t0 + 2
            if not (ok[i0] and ok[i1] and ok[i2]):
                continue
            e1, e2 = v[i1] - v[i0], v[i2] - v[i0]
            nrm = np.cross(e1, e2)
            nl = np.linalg.norm(nrm) or 1.0
            d = abs((nrm / nl) @ LIGHT)
            shade = np.clip(col[i0] * (0.35 + 0.65 * d), 0, 1)
            xs = np.array([sx[i0], sx[i1], sx[i2]])
            ys = np.array([sy[i0], sy[i1], sy[i2]])
            zs = np.array([sz[i0], sz[i1], sz[i2]])
            x0, x1 = int(max(0, xs.min())), int(min(w - 1, xs.max()) + 1)
            y0, y1 = int(max(0, ys.min())), int(min(h - 1, ys.max()) + 1)
            if x1 <= x0 or y1 <= y0:
                continue
            gx, gy = np.meshgrid(np.arange(x0, x1) + 0.5,
                                 np.arange(y0, y1) + 0.5)
            d00 = (xs[1] - xs[0]) * (gy - ys[0]) - (ys[1] - ys[0]) * (
                gx - xs[0])
            d11 = (xs[2] - xs[1]) * (gy - ys[1]) - (ys[2] - ys[1]) * (
                gx - xs[1])
            d22 = (xs[0] - xs[2]) * (gy - ys[2]) - (ys[0] - ys[2]) * (
                gx - xs[2])
            inside = ((d00 >= 0) & (d11 >= 0) & (d22 >= 0)) | \
                     ((d00 <= 0) & (d11 <= 0) & (d22 <= 0))
            if not inside.any():
                continue
            area = (xs[1] - xs[0]) * (ys[2] - ys[0]) - \
                (ys[1] - ys[0]) * (xs[2] - xs[0])
            if abs(area) < 1e-9:
                continue
            b2 = d00 / area
            b0 = d11 / area
            zi = b0 * zs[0] + (1 - b0 - b2) * zs[1] + b2 * zs[2]
            yi, xi = np.nonzero(inside)
            put(xi + x0, yi + y0, zi[inside], shade)

    # points: size-attenuated round sprites (page's progPts)
    if disp_particles and scene.par is not None and len(scene.par):
        sx, sy, sz, wc, ok = project(scene.par)
        col = scene.par_col if scene.par_col is not None else \
            np.tile(np.asarray(DEF_PT_COL, np.float32), (len(scene.par), 1))
        upx = scene.radius * h * 0.5 * 1.7320508
        size = np.clip(upx / np.maximum(wc, 1e-9), 1.0, 64.0)
        order = np.argsort(-sz)
        for i in order:
            if not ok[i]:
                continue
            r = size[i] / 2
            x0, x1 = int(sx[i] - r), int(sx[i] + r) + 1
            y0, y1 = int(sy[i] - r), int(sy[i] + r) + 1
            gx, gy = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
            m = ((gx + 0.5 - sx[i]) ** 2 + (gy + 0.5 - sy[i]) ** 2) <= r * r
            yi, xi = np.nonzero(m)
            if len(xi):
                put(xi + x0, yi + y0, np.full(len(xi), sz[i], np.float32),
                    col[i])
    return img


def fetch_and_render(url="http://127.0.0.1:8765", **kw):
    """Fetch /scene.bin from a live ViewerServer and render it."""
    from urllib.request import urlopen
    blob = urlopen(url.rstrip("/") + "/scene.bin").read()
    scene = parse_scene(blob)
    return scene, render(scene, **kw)
