"""GAN image pool (history buffer) on the device.

Port of ``csmri_refinement_tpu/training/image_pool.py``. The images live
in one (pool_size, H, W, C) tensor on the device; the fill count and every
decision are host values, so a query never waits on the card. Per batch
image, in order:

* while the pool is not full: store the image, return it unchanged;
* once full: with probability ``p`` return a random pool entry and store
  the incoming image in its place; otherwise return the image.

The decisions (a random index and a uniform draw per image that finds the
pool full) come from the caller's host ``torch.Generator``; JAX draws them
from split keys, so the streams differ while the rule is the same.
"""

import torch


class ImagePool:

  def __init__(self, pool_size, image_shape, device, dtype=torch.float32):
    self.pool_size = pool_size
    self.images = torch.zeros((pool_size,) + tuple(image_shape), dtype=dtype,
                              device=device)
    self.count = 0

  def draw(self, generator, p):
    """One image's (random index, use-pool) decision."""
    idx = int(torch.randint(self.pool_size, (), generator=generator))
    return idx, float(torch.rand((), generator=generator)) < p

  def query(self, image_batch, generator=None, p=0.5):
    """Mix ``image_batch`` (detached) with the pool; returns the batch the
    discriminator sees."""
    out = []
    for img in image_batch.detach():
      if self.count < self.pool_size:
        self.images[self.count] = img
        self.count += 1
        out.append(img)
        continue
      idx, use_pool = self.draw(generator, p)
      if use_pool:
        out.append(self.images[idx].clone())
        self.images[idx] = img
      else:
        out.append(img)
    return torch.stack(out)


def pool_size_from_conf(conf, disc_conf):
  """The pool's size, or None without a pool."""
  if not disc_conf.get('use_image_pool', False):
    return None
  return disc_conf.get('image_pool_size', 5 * conf.batch_size)
