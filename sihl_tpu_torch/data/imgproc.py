"""The image primitives that the data feed takes from OpenCV in the JAX
package, in numpy: resizing, RGB <-> HSV and polygon filling.

Each function follows one OpenCV call's arithmetic, so that the port's
augmentations and masks equal the JAX package's, which calls ``cv2``:

* :func:`resize` -- ``cv2.resize`` with ``INTER_LINEAR`` (float images) or
  ``INTER_NEAREST`` (any dtype);
* :func:`rgb_to_hsv`, :func:`hsv_to_rgb` -- ``cv2.cvtColor`` with
  ``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB`` on float32 images (hue in degrees);
* :func:`fill_poly` -- ``cv2.fillPoly(mask, [points], value)`` for one
  polygon with integer vertices (8-connected outline, no shift).
"""

import numpy as np

_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


# -- resizing ---------------------------------------------------------------


def nearest_indices(src: int, dst: int) -> np.ndarray:
    """The source index of each of ``dst`` outputs along an axis of ``src``
    pixels, as ``cv2.resize(..., interpolation=INTER_NEAREST)`` picks it:
    ``min(floor(x * (1 / (dst / src))), src - 1)`` in float64."""
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64), src - 1)


def linear_taps(src: int, dst: int):
    """The two source indices and float32 weights of each of ``dst`` outputs
    along an axis of ``src`` pixels, as ``cv2.resize(...,
    interpolation=INTER_LINEAR)`` computes them for float images: the
    half-pixel centre ``(x + 0.5) * (1 / (dst / src)) - 0.5``, its floor and
    fraction in float64, the fraction then rounded to float32; a centre
    left of pixel 0 takes pixel 0 alone, one at or right of the last pixel
    takes that pixel alone."""
    scale = 1.0 / (dst / src)
    centre = (np.arange(dst) + 0.5) * scale - 0.5
    index = np.floor(centre).astype(np.int64)
    frac = (centre - index).astype(np.float32)
    left, right = index < 0, index >= src - 1
    frac[left | right] = 0.0
    index[left] = 0
    index[right] = src - 1
    return index, np.minimum(index + 1, src - 1), np.float32(1.0) - frac, frac


def resize(image: np.ndarray, out_h: int, out_w: int, nearest: bool) -> np.ndarray:
    """``cv2.resize(image, (out_w, out_h), interpolation=INTER_NEAREST if
    nearest else INTER_LINEAR)`` for a 2-D map or an HWC array; the shape
    keeps its trailing axes (where cv2 drops a trailing axis of 1, this
    keeps it).  Linear resizing takes float32 inputs, as the pipelines give
    it: a horizontal pass over every source row, then a vertical one, each
    ``a * w0 + b * w1`` in float32 (cv2's vector code may fuse a
    multiply-add: the two agree within a few float32 ulps)."""
    h, w = image.shape[:2]
    if (h, w) == (out_h, out_w):
        return image.copy()
    if nearest:
        return image[nearest_indices(h, out_h)][:, nearest_indices(w, out_w)]
    if image.dtype != np.float32:
        raise TypeError(f"linear resizing takes float32 images, got {image.dtype}")
    x0, x1, a0, a1 = linear_taps(w, out_w)
    y0, y1, b0, b1 = linear_taps(h, out_h)
    trail = (1,) * (image.ndim - 2)
    a0, a1 = a0.reshape((1, -1) + trail), a1.reshape((1, -1) + trail)
    b0, b1 = b0.reshape((-1, 1) + trail), b1.reshape((-1, 1) + trail)
    # a * w0 + b * w1 in place, in that order: half the temporaries of the expression
    rows = np.take(image, x0, axis=1)
    rows *= a0
    right = np.take(image, x1, axis=1)
    right *= a1
    rows += right
    out = np.take(rows, y0, axis=0)
    out *= b0
    below = np.take(rows, y1, axis=0)
    below *= b1
    out += below
    return out


# -- colour -----------------------------------------------------------------


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_RGB2HSV)`` for a float32 HWC RGB image
    in [0, 1]: hue in degrees [0, 360), saturation and value in [0, 1], with
    cv2's epsilon terms (``s = (v - min) / (|v| + FLT_EPSILON)``, hue
    slopes ``60 / (diff + FLT_EPSILON)``, that quotient in float64)."""
    image = np.asarray(image, np.float32)
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _FLT_EPSILON)
    slope = (60.0 / (diff + _FLT_EPSILON).astype(np.float64)).astype(np.float32)
    h = np.where(v == r, (g - b) * slope,
                 np.where(v == g, (b - r) * slope + np.float32(120.0), (r - g) * slope + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


# (b, g, r) taken from (v, v(1 - s), v(1 - s h), v(1 - s(1 - h))) in each sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_HSV2RGB)`` for a float32 HWC HSV image
    with hue in degrees: ``h * (6 / 360)`` in float32 brought into [0, 6),
    its sector ``floor(h)`` and fraction, and cv2's table of products."""
    image = np.asarray(image, np.float32)
    h = image[..., 0] * np.float32(6.0 / 360.0)
    s, v = image[..., 1], image[..., 2]
    # cv2 adds or subtracts 6 until h lies in [0, 6); a hue within (-360, 720) needs at most one step
    h = np.where(h < 0, h + np.float32(6.0), np.where(h >= 6, h - np.float32(6.0), h))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector[bad] = 0
    h[bad] = 0.0
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], axis=-1)
    picks = _SECTORS[sector]
    b, g, r = (np.take_along_axis(tab, picks[..., i : i + 1], axis=-1)[..., 0] for i in range(3))
    return np.stack([r, g, b], axis=-1).astype(np.float32)


# -- polygons ---------------------------------------------------------------


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::clipLine`` on an image of ``width`` x ``height``: the segment's
    ends moved onto the image's border (float64 quotients truncated toward
    zero), and whether any of it lies inside."""
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_pixels(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels of ``cv2.line(..., lineType=LINE_8)`` from (x1, y1) to (x2,
    y2), clipped to the image as cv2's ``LineIterator`` clips it: xs and ys.
    Bresenham's walk from the left end: a step along the major axis each
    pixel, and one along the minor axis where the error term is negative;
    after ``i`` steps the minor axis has moved ``ceil((2 b i - a) / 2a)``
    pixels (``a``, ``b`` the major and minor lengths)."""
    outside = not (0 <= x1 < width and 0 <= x2 < width and 0 <= y1 < height and 0 <= y2 < height)
    if outside:
        inside, x1, y1, x2, y2 = _clip_line(width, height, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = max(dx, dy), min(dx, dy)
    steps = np.arange(major + 1, dtype=np.int64)
    moved = -((major - 2 * minor * steps) // (2 * major)) if major else steps
    if dy > dx:
        return x1 + moved, y1 + sy * steps
    return x1 + steps, y1 + sy * moved


def _c_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C's integer division of int64 arrays, toward zero."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def fill_poly(mask: np.ndarray, points, value=1) -> np.ndarray:
    """``cv2.fillPoly(mask, [points], value)`` for one polygon of integer
    vertices ``points`` (N, 2) xy, in place on a 2-D ``mask``; returns it.

    cv2's rule for ``LINE_8`` without shift: every edge is drawn as an
    8-connected line (:func:`_line_pixels`), and each row ``y`` fills,
    between consecutive pairs of the sorted crossings of the edges active
    on it (an edge from row y0 to row y1 is active on [y0, y1)), the
    columns from ``ceil(left)`` to ``floor(right)``.  A crossing is in
    16.16 fixed point: ``x0 << 16`` on the edge's upper row, moved by
    ``((x1 - x0) << 16) / (y1 - y0)``, truncated, a row.  An edge with an
    end off the image takes its line's clipped ends (``cv::clipLine``) for
    its x's, and for its rows too where those differ, and is projected
    from them back to its upper row."""
    height, width = mask.shape
    pts = np.asarray(points, np.int64).reshape(-1, 2)
    for (x0, y0), (x1, y1) in zip(np.roll(pts, 1, axis=0).tolist(), pts.tolist()):
        xs, ys = _line_pixels(width, height, x0, y0, x1, y1)
        mask[ys, xs] = value
    start, end = np.roll(pts, 1, axis=0), pts
    slanted = start[:, 1] != end[:, 1]
    if slanted.sum() < 2:
        return mask
    start, end = start[slanted], end[slanted]
    clipped_start, clipped_end = start.copy(), end.copy()
    for i, ((x0, y0), (x1, y1)) in enumerate(zip(start.tolist(), end.tolist())):
        if not (0 <= x0 < width and 0 <= x1 < width and 0 <= y0 < height and 0 <= y1 < height):
            _, t0x, t0y, t1x, t1y = _clip_line(width, height, x0, y0, x1, y1)
            clipped_start[i, 0], clipped_end[i, 0] = t0x, t1x
            if t0y != t1y:
                clipped_start[i, 1], clipped_end[i, 1] = t0y, t1y
    down = start[:, 1] < end[:, 1]
    top = np.where(down[:, None], start, end)
    bottom = np.where(down[:, None], end, start)
    slope = _c_div((clipped_end[:, 0] - clipped_start[:, 0]) << _XY_SHIFT, clipped_end[:, 1] - clipped_start[:, 1])
    anchor = np.where(down[:, None], clipped_start, clipped_end)
    x_top = (anchor[:, 0] << _XY_SHIFT) + (top[:, 1] - anchor[:, 1]) * slope
    rows = bottom[:, 1] - top[:, 1]
    edge = np.repeat(np.arange(len(rows)), rows)
    step = np.arange(rows.sum()) - np.repeat(np.cumsum(rows) - rows, rows)
    y = top[edge, 1] + step
    x = x_top[edge] + step * slope[edge]
    # each row pairs its own crossings, so rows off the image drop out whole
    inside = (y >= 0) & (y < height)
    y, x = y[inside], x[inside]
    order = np.lexsort((x, y))
    y, x = y[order].reshape(-1, 2)[:, 0], x[order].reshape(-1, 2)
    left, right = (x[:, 0] + _XY_ONE - 1) >> _XY_SHIFT, x[:, 1] >> _XY_SHIFT
    keep = (left < width) & (right >= 0) & (left <= right)
    y, left, right = y[keep], np.maximum(left[keep], 0), np.minimum(right[keep], width - 1)
    marks = np.zeros((height, width + 1), np.int64)
    np.add.at(marks, (y, left), 1)
    np.add.at(marks, (y, right + 1), -1)
    mask[np.cumsum(marks[:, :width], axis=1) > 0] = value
    return mask
