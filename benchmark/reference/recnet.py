"""Plain reference of the ``recnet`` configuration (``configs/1-recnet.json``
of csmri-refinement): RecNet with data consistency, MSE and Adam, in
float32 with TF32 off.

It follows the paper's description (arXiv:1806.11216; the cascade of
Schlemper et al., arXiv:1703.00555): ``num_blocks`` blocks of
``num_convs`` SAME zero-padded k × k convs, LeakyReLU(0.01) after all but
the last, each block followed by the data-consistency step

    x' = ifft2((1 − mask) · fft2(x) + k0)      (ortho, unshifted FFTs)

on the image packed as (B, H, W, 2) real and imaginary channels. The
loss is the mean of the squared difference to the target over every
element; Adam is written out (bias-corrected moments, eps outside the
square root). It imports nothing of the program: it is given the weights
and the batches the benchmark made, by the names of the program's module
tree, and works everything else out again.
"""

import contextlib

import torch
import torch.nn.functional as F

LEAK = 0.01


@contextlib.contextmanager
def exact_f32():
  """TF32 off for convolutions and matmuls inside the block."""
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def model_conf(section):
  """The RecNet section with the source code's defaults filled in."""
  conf = {'kernel_size': 3, 'num_final_outputs': 2}
  conf.update(section)
  return conf


def param_shapes(section, prefix=''):
  """{name: shape} of the cascade's parameters."""
  conf = model_conf(section)
  k, shapes = conf['kernel_size'], {}
  for b in range(conf['num_blocks']):
    cin = 2
    for j in range(conf['num_convs']):
      last = j == conf['num_convs'] - 1
      cout = (conf['num_final_outputs'] if b == conf['num_blocks'] - 1
              else 2) if last else conf['num_filters']
      name = '{}block_{}.conv_{}'.format(prefix, b, j)
      shapes[name + '.weight'] = (cout, cin, k, k)
      shapes[name + '.bias'] = (cout,)
      cin = cout
  return shapes


FP8_MAX = 448.0   # the largest finite float8 e4m3


def fake_fp8(t, dims):
  """``t`` rounded to float8 e4m3 with one scale per slice over ``dims``
  (the largest |t| maps to 448, as Hopper's fp8 tensor cores are fed),
  returned in float32."""
  scale = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / FP8_MAX
  return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def conv(h, weight, bias=None, padding=0, fp8=False):
  """``F.conv2d``; with ``fp8`` the input rounded per image and the
  weight per output channel first (the control's precision)."""
  if fp8:
    h, weight = fake_fp8(h, (1, 2, 3)), fake_fp8(weight, (1, 2, 3))
  return F.conv2d(h, weight, bias, padding=padding)


def data_consistency(x, k0, mask):
  """x, k0: (B, H, W, 2); mask: (B, H, W, 1) → (B, H, W, 2)."""
  k = torch.fft.fft2(torch.complex(x[..., 0], x[..., 1]), norm='ortho')
  k = (1.0 - mask[..., 0]) * k + torch.complex(k0[..., 0], k0[..., 1])
  y = torch.fft.ifft2(k, norm='ortho')
  return torch.stack([y.real, y.imag], dim=-1)


def forward(section, weights, inp, kspace, mask, prefix='', fp8=False):
  """The cascade on (B, H, W, 2) float32 inputs (``fp8``: its convs in
  the control's precision)."""
  conf = model_conf(section)
  x = inp.float()
  for b in range(conf['num_blocks']):
    h = x.permute(0, 3, 1, 2)
    for j in range(conf['num_convs']):
      name = '{}block_{}.conv_{}'.format(prefix, b, j)
      h = conv(h, weights[name + '.weight'], weights[name + '.bias'],
               conf['kernel_size'] // 2, fp8)
      if j < conf['num_convs'] - 1:
        h = F.leaky_relu(h, LEAK)
    x = data_consistency(h.permute(0, 2, 3, 1), kspace, mask)
  return x


def train_steps(conf, weights, batches, moments=None, steps=0):
  """Adam steps of the MSE loss from ``weights``, one a batch.

  ``moments`` ({'exp_avg': {name: m}, 'exp_avg_sq': {name: v}}, Adam's
  state after ``steps`` earlier steps) starts the optimizer where a run
  left it; without it the moments start at zero and ``steps`` at 0.
  Returns {'loss': [each step's loss], 'out': the first step's output,
  'grad': {name: the norm of the first step's gradient}, 'change': {name:
  the norm of the parameters' change after the last step}}, norms in
  float64."""
  opt = conf['optimizer']
  lr = opt['learning_rate']
  b1, b2, eps = opt.get('beta1', 0.9), opt.get('beta2', 0.999), 1e-8
  names = list(param_shapes(conf['model']))
  params = {n: weights[n].detach().clone().float().requires_grad_()
            for n in names}
  if moments is None:
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
  else:
    m = {n: moments['exp_avg'][n].detach().clone().float() for n in names}
    v = {n: moments['exp_avg_sq'][n].detach().clone().float()
         for n in names}
  out = {'loss': []}
  with exact_f32():
    for t, batch in enumerate(batches, start=steps + 1):
      pred = forward(conf['model'], params, batch['inp'], batch['kspace'],
                     batch['mask'])
      loss = torch.mean((pred - batch['target'].float()) ** 2)
      grads = torch.autograd.grad(loss, [params[n] for n in names])
      out['loss'].append(float(loss.detach()))
      if t == steps + 1:
        out['out'] = pred.detach()
        out['grad'] = {n: float(g.double().norm())
                       for n, g in zip(names, grads)}
      with torch.no_grad():
        for n, g in zip(names, grads):
          m[n].mul_(b1).add_(g, alpha=1 - b1)
          v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
          mhat = m[n] / (1 - b1 ** t)
          vhat = v[n] / (1 - b2 ** t)
          params[n].sub_(lr * mhat / (vhat.sqrt() + eps))
  out['change'] = {n: float((params[n].detach() - weights[n]).double().norm())
                   for n in names}
  return out
