"""Host-side data augmentation (scipy), drawn from an explicit RandomState.

Port of ``csmri_refinement_tpu/data/augment.py``, line for line: elastic
deformation, random translate, rotate (single and paired), zoom through
``clipped_zoom`` (single and paired), which the host transforms call, and
gaussian noise and blur, centre and random crops, which no transform
calls. Each function draws from the ``rng`` it is given,
in the JAX module's order (``random_translate`` draws the width's offset
before the height's), so equal ``RandomState``s give equal arrays, bit for
bit.

Operates on HWC numpy arrays. The pair variants interpolate image channels
with a high spline order and label channels with order 0.
"""

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates, rotate, zoom


def elastic_transform(image, alpha, sigma, rng, spline_order=1,
                      mode='nearest'):
  """Simard-style elastic deformation of an HWC image."""
  if image.ndim != 3:
    raise ValueError('elastic_transform takes an HWC image')
  shape = image.shape[:2]

  dx = gaussian_filter((rng.rand(*shape) * 2 - 1), sigma,
                       mode='constant', cval=0) * alpha
  dy = gaussian_filter((rng.rand(*shape) * 2 - 1), sigma,
                       mode='constant', cval=0) * alpha

  x, y = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing='ij')
  indices = [np.reshape(x + dx, (-1, 1)), np.reshape(y + dy, (-1, 1))]
  result = np.empty_like(image)
  for i in range(image.shape[2]):
    result[:, :, i] = map_coordinates(
        image[:, :, i], indices, order=spline_order, mode=mode).reshape(shape)
  return result


def random_translate(image, translation, rng):
  """Shift by uniform integer offsets, zero-filling vacated pixels."""
  if isinstance(translation, (int, float)):
    translation = (int(translation), int(translation))
  h, w = image.shape[:2]
  th, tw = translation
  if th == 0 and tw == 0:
    return image
  tw = 0 if tw == 0 else rng.randint(-tw, tw)
  th = 0 if th == 0 else rng.randint(-th, th)
  x1, x2 = max(0, tw), min(w + tw, w)
  y1, y2 = max(0, th), min(h + th, h)
  out = np.zeros_like(image)
  out[:y2 - y1, :x2 - x1] = image[y1:y2, x1:x2]
  return out


def random_rotate(image, angle_range, rng, mode='reflect', order=2):
  """Rotate by a uniform angle, clipping to the input's value range."""
  angle = rng.uniform(angle_range[0], angle_range[1])
  mi, ma = image.min(), image.max()
  out = rotate(image, angle, reshape=False, axes=(0, 1), mode=mode,
               order=order)
  return np.clip(out, mi, ma)


def random_rotate_pair(image, label, angle_range, rng, mode='reflect',
                       orders=(2, 0)):
  """Jointly rotate image (interpolated) and label (nearest)."""
  angle = rng.uniform(angle_range[0], angle_range[1])
  mi, ma = image.min(), image.max()
  img = np.clip(rotate(image, angle, reshape=False, axes=(0, 1),
                       mode=mode, order=orders[0]), mi, ma)
  mi, ma = label.min(), label.max()
  lab = np.clip(rotate(label, angle, reshape=False, axes=(0, 1),
                       mode=mode, order=orders[1]), mi, ma)
  return img, lab


def clipped_zoom(img, zoom_factor, order=2):
  """Zoom keeping the output shape: pad when zooming out, crop when in."""
  h, w = img.shape[:2]
  zh = int(np.round(zoom_factor * np.float32(h)))
  zw = int(np.round(zoom_factor * np.float32(w)))
  zoom_tuple = (zoom_factor, zoom_factor) + (1,) * (img.ndim - 2)

  if zoom_factor < 1:
    top = (h - zh) // 2
    left = (w - zw) // 2
    out = np.zeros_like(img)
    out[top:top + zh, left:left + zw] = zoom(img, zoom_tuple, order=order)
  elif zoom_factor > 1:
    top = (zh - h) // 2
    left = (zw - w) // 2
    out = zoom(img[top:top + zh, left:left + zw], zoom_tuple, order=order)
    trim_top = (out.shape[0] - h) // 2
    trim_left = (out.shape[1] - w) // 2
    out = out[trim_top:trim_top + h, trim_left:trim_left + w]
  else:
    out = img.copy()
  return out


def random_zoom(image, zoom_range, rng, order=2):
  factor = rng.uniform(zoom_range[0], zoom_range[1])
  return clipped_zoom(image, factor, order=order)


def random_zoom_pair(image, label, zoom_range, rng, orders=(2, 0)):
  factor = rng.uniform(zoom_range[0], zoom_range[1])
  return (clipped_zoom(image, factor, order=orders[0]),
          clipped_zoom(label, factor, order=orders[1]))


def gaussian_noise(image, sigma, rng):
  """Additive gaussian noise of std ``sigma``, in the image's dtype."""
  return image + sigma * rng.randn(*image.shape).astype(image.dtype)


def gaussian_blur(image, sigma):
  """Gaussian blur over the spatial dims of an HWC image."""
  out = np.empty_like(image)
  for c in range(image.shape[2]):
    out[:, :, c] = gaussian_filter(image[:, :, c], sigma)
  return out


def center_crop(image, size):
  """Centre crop of an HWC image to (size, size)."""
  if isinstance(size, int):
    size = (size, size)
  h, w = image.shape[:2]
  top = (h - size[0]) // 2
  left = (w - size[1]) // 2
  return image[top:top + size[0], left:left + size[1]]


def random_crop(image, size, rng):
  """Random crop of an HWC image to (size, size): the top row, then the
  left column, from ``rng``."""
  if isinstance(size, int):
    size = (size, size)
  h, w = image.shape[:2]
  top = rng.randint(0, h - size[0] + 1)
  left = rng.randint(0, w - size[1] + 1)
  return image[top:top + size[0], left:left + size[1]]
