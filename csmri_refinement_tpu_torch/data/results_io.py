"""Saved reconstruction results and their ground-truth labels, for offline
evaluation.

Port (a copy) of ``csmri_refinement_tpu/data/results_io.py``: a directory
of per-slice ``.mat`` records (the validate CLI's ``--raw`` format, or the
external "jo" format of complex volumes) and each record's ScarSeg label,
by case and slice.
"""

import glob
import os

import numpy as np
from scipy.io import loadmat

from csmri_refinement_tpu_torch.data.io_mat import (CaseDataset, IMAGE_KEYS,
                                              INPUT_KEY, PRED_KEY,
                                              TARGET_KEY, TARGET_LABEL_KEY,
                                              load_from_raw)
from csmri_refinement_tpu_torch.data.analyze_io import load_analyze
from csmri_refinement_tpu_torch.data.datasets import (LABEL_PATH, NUM_SLICES,
                                                      STATIC_SPLIT,
                                                      SliceDataset)


def load_from_jo_format(filepath, pred_key):
  """External format: complex volumes with slice_names/seq_und/seq_gnd."""
  def complex_to_two_channels(x):
    # channel-last packing to match the framework layout
    return np.stack((np.real(x), np.imag(x)), axis=-1)

  assert pred_key is not None, \
      'Need prediction key when loading from Jo format'
  mat = loadmat(filepath)

  data = []
  for name, inp, pred, target in zip(mat['slice_names'],
                                     mat['seq_und'].transpose((2, 0, 1)),
                                     mat[pred_key].transpose((2, 0, 1)),
                                     mat['seq_gnd'].transpose((2, 0, 1))):
    name = str(name[0][0][0])
    case, slice_idx = SliceDataset.get_case_and_slice(name)
    data.append({
        'case': case,
        'slice': int(slice_idx),
        INPUT_KEY: complex_to_two_channels(inp),
        PRED_KEY: complex_to_two_channels(pred),
        TARGET_KEY: complex_to_two_channels(target),
    })
  return data


def load_results_dataset(path, only_load_keys=IMAGE_KEYS,
                         data_format='default', pred_key=None):
  files = sorted(glob.glob(os.path.join(path, '*.mat')))
  data = []
  if data_format == 'jo':
    for file in files:
      data += load_from_jo_format(file, pred_key)
  else:
    for file in files:
      data.append(load_from_raw(file, only_load_keys))
  return data


def load_gt_label(case_folder):
  labels = load_analyze(os.path.join(case_folder,
                                     LABEL_PATH))[..., :NUM_SLICES]
  res_labels = []
  for slice_idx in range(labels.shape[-1]):
    label = labels[:, :, slice_idx]
    res_labels.append(np.ceil(label).astype(np.uint8))
  return res_labels


def add_gt_labels(dataset, dataset_path, fold):
  """Attach GT labels to loaded results per case and slice."""
  dataset = CaseDataset(dataset)
  case_ids = STATIC_SPLIT['val'] if fold == 'val' else STATIC_SPLIT['test']

  for case in case_ids:
    case_folder = os.path.join(dataset_path, case)
    labels = load_gt_label(case_folder)
    for slice_idx, label in enumerate(labels):
      try:
        data = dataset.get_data(case, slice_idx)
      except ValueError:
        print('Warning: did not find {}, slice {} but they are in '
              'GT.'.format(case, slice_idx))
        continue
      data[TARGET_LABEL_KEY] = label
      data['has_class_1'] = bool(np.any(label == 1))
  return dataset
