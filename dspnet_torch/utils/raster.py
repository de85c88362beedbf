"""Polygon rasterisation without cv2: :func:`fill_poly` paints the pixels
``cv2.fillPoly(img, [pts], value)`` paints (int32 points, ``lineType`` 8,
``shift`` 0), bit for bit, on a 2-D image of any integer dtype.

cv2 (``modules/imgproc/src/drawing.cpp``) does two things for a polygon:

* ``CollectPolyEdges`` draws every edge, horizontal ones included, with its
  8-connected Bresenham ``Line`` (the ``LineIterator`` of a line clipped to
  the image by ``clipLine``), and turns each non-horizontal edge into a
  16.16 fixed-point edge ``(y0, y1, x, dx)``: ``dx`` is the int64 quotient
  truncated toward zero, and an edge whose line leaves the image takes its
  slope from the clipped line's ends (their x always, their y unless they
  share a row), extrapolated back to its unclipped first row;
* ``FillEdgeCollection`` walks the rows: on row ``y`` the edges with
  ``y0 <= y < y1`` stand at ``x + (y - y0) dx``, sorted, and each
  consecutive pair fills from the left one's ceiling to the right one's
  floor, clipped to the row.

So the boundary pixels come from the lines as well as from the spans, and an
even-odd scanline fill alone differs from cv2 there. These rules are cv2
5.0.0's, measured against it (``tests/test_torch_tools.py`` holds the port to
cv2 and to a scalar transcription of the two loops). Here the lines are
computed in closed form for all edges at once and the spans for all rows at
once (one sort of every (row, x) crossing), then painted through a
difference array over the polygon's bounding box.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _trunc_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C's int64 division (toward zero)."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def clip_lines(width: int, height: int, x1, y1, x2, y2):
    """cv2's ``clipLine(Size, Point2l&, Point2l&)`` over arrays of segments:
    the (possibly partly) clipped endpoints and whether the segment meets the
    image. The updates happen in cv2's order (y of the first end, y of the
    second from the updated first, then x likewise), with its float64
    products truncated toward zero, and stand even where the segment misses
    the image (the caller reads them)."""
    x1, y1, x2, y2 = (np.array(v, np.int64) for v in (x1, y1, x2, y2))
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def shift(a, d_num, d_den):  # (int64)((double)a * d_num / d_den), guarded where unused
        den = np.where(d_den == 0, 1, d_den).astype(np.float64)
        return np.trunc(a.astype(np.float64) * d_num.astype(np.float64) / den).astype(np.int64)

    c1, c2 = code(x1, y1), code(x2, y2)
    work = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = work & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(m, x1 + shift(a - y1, x2 - x1, y2 - y1), x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, (x1 < 0) + (x1 > right) * 2, c1)
    m = work & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(m, x2 + shift(a - y2, x2 - x1, y2 - y1), x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, (x2 < 0) + (x2 > right) * 2, c2)
    work &= ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = work & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(m, y1 + shift(a - x1, y2 - y1, x2 - x1), y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = work & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(m, y2 + shift(a - x2, y2 - y1, x2 - x1), y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return x1, y1, x2, y2, (c1 | c2) == 0


def line_pixels(width: int, height: int, x1, y1, x2, y2):
    """The pixels cv2's 8-connected ``Line`` paints for each segment (the
    ``LineIterator`` with ``leftToRight``), concatenated: (ys, xs). A segment
    that misses the image paints nothing.

    The iterator starts at the left end (the first one when vertical), steps
    the major axis every pixel and the minor one where its error term goes
    negative: after k steps it has moved ``ceil((2 d_minor k - d_major) /
    (2 d_major))`` along the minor axis."""
    x1, y1, x2, y2 = (np.asarray(v, np.int64) for v in (x1, y1, x2, y2))
    inside = (x1 >= 0) & (x1 < width) & (x2 >= 0) & (x2 < width) & \
             (y1 >= 0) & (y1 < height) & (y2 >= 0) & (y2 < height)
    cx1, cy1, cx2, cy2, ok = clip_lines(width, height, x1, y1, x2, y2)
    x1, y1, x2, y2 = (np.where(inside, a, b) for a, b in ((x1, cx1), (y1, cy1), (x2, cx2), (y2, cy2)))
    keep = inside | ok
    x1, y1, x2, y2 = x1[keep], y1[keep], x2[keep], y2[keep]
    swap = x2 < x1  # leftToRight
    x1, x2 = np.where(swap, x2, x1), np.where(swap, x1, x2)
    y1, y2 = np.where(swap, y2, y1), np.where(swap, y1, y2)
    dx, dy = x2 - x1, np.abs(y2 - y1)
    sy = np.where(y2 < y1, -1, 1)
    vert = dy > dx
    major, minor = np.where(vert, dy, dx), np.where(vert, dx, dy)
    count = major + 1
    seg = np.repeat(np.arange(len(count)), count)
    k = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)
    maj, mnr = major[seg], minor[seg]
    steps = -((maj - 2 * mnr * k) // np.maximum(2 * maj, 1))  # ceil((2 minor k - major) / (2 major))
    steps = np.where(maj == 0, 0, steps)
    v = vert[seg]
    xs = x1[seg] + np.where(v, steps, k)
    ys = y1[seg] + np.where(v, k, steps) * sy[seg]
    return ys, xs


def poly_edges(width: int, height: int, pts: np.ndarray):
    """cv2's ``CollectPolyEdges`` for one closed polygon (shift 0, no offset):
    the line of every edge, (ys, xs), and the non-horizontal edges as int64
    arrays (y0, y1, x, dx) in 16.16 fixed point."""
    p1 = pts.reshape(-1, 2).astype(np.int64)
    p0 = np.roll(p1, 1, axis=0)  # edge i runs from vertex i-1 to vertex i
    x0, y0, x1, y1 = p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1]
    lines = line_pixels(width, height, x0, y0, x1, y1)

    outside = (np.minimum(x0, x1) < 0) | (np.maximum(x0, x1) >= width) | \
              (np.minimum(y0, y1) < 0) | (np.maximum(y0, y1) >= height)
    cx0, cy0, cx1, cy1, _ = clip_lines(width, height, x0, y0, x1, y1)
    # the ends the slope is taken from: where the line leaves the image, the
    # clipped ends' x (whether or not the clip met the image) and, unless
    # they share a row, their y
    fx0 = np.where(outside, cx0, x0) << XY_SHIFT
    fx1 = np.where(outside, cx1, x1) << XY_SHIFT
    rows_clipped = outside & (cy0 != cy1)
    fy0, fy1 = np.where(rows_clipped, cy0, y0), np.where(rows_clipped, cy1, y1)
    e = y0 != y1
    x0, y0, y1, fx0, fx1, fy0, fy1 = (a[e] for a in (x0, y0, y1, fx0, fx1, fy0, fy1))
    dx = _trunc_div(fx1 - fx0, fy1 - fy0)
    down = y0 < y1
    top = np.where(down, y0, y1)
    x = np.where(down, fx0 + (y0 - fy0) * dx, fx1 + (y1 - fy1) * dx)
    return lines, (top, np.where(down, y1, y0), x, dx)


def fill_spans(width: int, height: int, edges):
    """cv2's ``FillEdgeCollection`` (``lineType`` 8): every filled span, as
    (rows, x_left, x_right) inclusive and clipped to the image."""
    y0, y1, x, dx = edges
    empty = (np.zeros(0, np.int64),) * 3
    if len(y0) < 2:
        return empty
    lo, hi = np.maximum(y0, 0), np.minimum(y1, height)
    n = np.maximum(hi - lo, 0)
    if not n.any():
        return empty
    e = np.repeat(np.arange(len(n)), n)
    rows = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n) + lo[e]
    xs = x[e] + (rows - y0[e]) * dx[e]
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    # each row holds an even number of crossings (a closed polygon's edges
    # cover [y0, y1)), so the sorted crossings pair up within their rows
    r, xl, xr = rows[0::2], (xs[0::2] + XY_ONE - 1) >> XY_SHIFT, xs[1::2] >> XY_SHIFT
    keep = (xl < width) & (xr >= 0)
    return r[keep], np.maximum(xl[keep], 0), np.minimum(xr[keep], width - 1)


def fill_poly(img: np.ndarray, pts, value) -> np.ndarray:
    """Paint one polygon into ``img`` (2-D, integer dtype) in place as
    ``cv2.fillPoly(img, [pts], value)`` does with int32 points, ``lineType``
    8 and ``shift`` 0, and return it. ``pts``: (N, 2) or (N, 1, 2) integer
    vertices (x, y), which may lie outside the image; any polygon is taken,
    concave, self-intersecting or degenerate."""
    if img.ndim != 2:
        raise ValueError(f"fill_poly paints 2-D images, got {img.shape}")
    pts = np.asarray(pts)
    if pts.size == 0:
        return img
    height, width = img.shape
    (ly, lx), edges = poly_edges(width, height, pts)
    rows, xl, xr = fill_spans(width, height, edges)
    if len(rows):
        r0, r1 = int(rows.min()), int(rows.max()) + 1
        c0, c1 = int(xl.min()), int(xr.max()) + 1
        w = c1 - c0 + 1
        flat = (rows - r0) * w
        diff = np.bincount(flat + xl - c0, minlength=(r1 - r0) * w) - \
            np.bincount(flat + xr + 1 - c0, minlength=(r1 - r0) * w)
        mask = np.cumsum(diff.reshape(r1 - r0, w)[:, :-1], axis=1) > 0
        img[r0:r1, c0:c1][mask] = value
    img[ly, lx] = value
    return img
