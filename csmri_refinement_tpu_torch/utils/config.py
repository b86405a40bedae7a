"""JSON configuration system.

Port (a copy, so the port imports nothing of the JAX package) of
``csmri_refinement_tpu/utils/config.py``:

* ``Configuration.from_json`` loads JSON files; any object may contain an
  ``#include`` key (string or list of paths, relative to the including file)
  whose contents are merged in underneath the local keys.
* A top-level ``include`` mapping ``{attr_key: path}`` loads a sub-config
  file into attribute ``attr_key``; the empty key ``""`` merges at the root.
  Pre-existing dict values override the included file's values.
* ``seed`` is a first-class field stored privately and inherited by child
  configurations.
* ``update`` applies CLI ``key=value`` overrides with string→typed
  conversion for bool/int/float/list/JSON.
* ``to_param_dict`` binds config attributes to constructor keyword
  arguments with required/optional/rename lists.
"""

import json
import os

JSON_TYPE_TAG = '__type__'
_TYPE_NAME = 'Configuration'


class Configuration:
  """Attribute-style configuration with include/merge/override semantics."""

  def __init__(self):
    self._seed = 0
    self._src_file = None

  # -- attribute access -----------------------------------------------------

  @property
  def seed(self):
    return self._seed

  @property
  def file(self):
    """The JSON file the configuration came from (None for a dict)."""
    return self._src_file

  def has_attr(self, key):
    return key in self.__dict__

  def get_attr(self, key, default=None, alternative=None):
    """Return attribute ``key``, or ``default``, or attribute ``alternative``.

    If ``alternative`` is given and ``key`` is missing, the alternative
    attribute is looked up instead and must resolve to a non-None value.
    """
    if key in self.__dict__:
      return self.__dict__[key]
    value = default
    if alternative is not None:
      value = self.get_attr(alternative)
      if value is None:
        raise ValueError(
            'Configuration did not contain {} or alternative {}'.format(
                key, alternative))
    return value

  # -- serialization --------------------------------------------------------

  def to_dict(self):
    """Plain-dict view including private fields (for serialization)."""
    out = {}
    for key, value in self.__dict__.items():
      if isinstance(value, Configuration):
        value = value.to_dict()
      out[key] = value
    return out

  def serialize(self, dst):
    """Dump the resolved configuration as JSON to ``dst``."""
    with open(dst, 'w') as f:
      json.dump(self.to_dict(), f, indent=2,
                default=lambda obj: getattr(obj, '__dict__', str(obj)))

  # -- mutation --------------------------------------------------------------

  def update(self, values_by_keys):
    """Apply string overrides, converting to bool/int/float/list if possible."""
    for key, value in values_by_keys.items():
      value = _convert(value) if isinstance(value, str) else value
      if key == 'seed':
        self._seed = value
      else:
        self.__dict__[key] = value

  # -- constructor binding ----------------------------------------------------

  def to_param_dict(self, required_params=(), optional_params=(),
                    key_renames=None):
    """Bind config attrs to a kwargs dict.

    ``required_params`` must be present (asserted); ``optional_params`` may
    be a list (included only if present) or a dict of defaults (always
    included). ``key_renames`` remaps config keys to kwarg names.
    """
    key_renames = key_renames or {}
    params = {}
    for key in required_params:
      value = self.get_attr(key)
      assert value is not None, \
          'Parameter {} is marked as required'.format(key)
      params[key] = value

    if isinstance(optional_params, dict):
      for key, default_value in optional_params.items():
        params[key] = self.get_attr(key, default=default_value)
    else:
      for key in optional_params:
        value = self.get_attr(key)
        if value is not None:
          params[key] = value

    return {key_renames.get(k, k): v for k, v in params.items()}

  # -- construction ------------------------------------------------------------

  @staticmethod
  def from_dict(dictionary, parent_config=None):
    """Build a Configuration from a dict, inheriting seed/file from parent."""
    if isinstance(dictionary, Configuration):
      return dictionary
    conf = Configuration()
    for key, value in dictionary.items():
      if key == 'seed':
        conf._seed = value
      elif key != JSON_TYPE_TAG:
        conf.__dict__[key] = value

    if parent_config is not None:
      conf._seed = parent_config._seed
      conf._src_file = parent_config._src_file

    return conf

  @staticmethod
  def from_json(src):
    """Load a Configuration from a JSON file, resolving includes."""
    with open(src, 'r') as f:
      data = json.load(f)

    data = _resolve_hash_includes(data, os.path.dirname(src))
    conf = Configuration.from_dict(data)
    conf._src_file = src

    # Top-level `include`: {attr_key: path} keyed sub-config merge.
    if conf.has_attr('include'):
      includes = conf.__dict__.pop('include')
      for key, path in includes.items():
        if not os.path.isabs(path):
          path = os.path.join(os.path.dirname(src), path)
        sub_conf = Configuration.from_json(path)
        if key == '':
          # Merge at root; local keys win.
          merged = dict(sub_conf.to_dict())
          merged.update(conf.__dict__)
          conf.__dict__ = merged
        else:
          saved_value = conf.get_attr(key, default=None)
          sub_dict = {k: v for k, v in sub_conf.__dict__.items()
                      if not k.startswith('_')}
          conf.__dict__[key] = sub_dict
          if isinstance(saved_value, dict):
            conf.__dict__[key].update(saved_value)

    return conf


def _resolve_hash_includes(obj, base_dir):
  """Recursively expand ``#include`` keys inside dicts.

  Included values load first, so local keys win on conflict (matches the
  reference's json object_hook order at utils/config.py:7-33).
  """
  if isinstance(obj, list):
    return [_resolve_hash_includes(item, base_dir) for item in obj]
  if not isinstance(obj, dict):
    return obj

  result = {}
  if '#include' in obj:
    includes = obj['#include']
    if not isinstance(includes, list):
      includes = [includes]
    for path in includes:
      if not os.path.isabs(path):
        path = os.path.join(base_dir, path)
      with open(path, 'r') as f:
        sub = json.load(f)
      sub = _resolve_hash_includes(sub, os.path.dirname(path))
      result.update(sub)

  for key, value in obj.items():
    if key == '#include':
      continue
    result[key] = _resolve_hash_includes(value, base_dir)
  return result


def _convert(s):
  """Convert a CLI override string into a typed Python value.

  JSON values are supported (so ``--conf 'optimizer={"name": "Adam", ...}'``
  can override whole sub-configs — the reference's converter handled flat
  lists only, utils/config.py:120-141); non-JSON falls back to the
  reference-compatible bool/int/float/list rules.
  """
  s = s.strip()
  if s.startswith('{') or s.startswith('['):
    try:
      return json.loads(s)
    except ValueError:
      pass
  if (s.startswith('[') and s.endswith(']')) or \
     (s.startswith('(') and s.endswith(')')):
    inner = s[1:-1].strip()
    if not inner:
      return []
    return [_convert(elem) for elem in inner.split(',')]
  if s == 'False':
    return False
  if s == 'True':
    return True
  try:
    return int(s)
  except ValueError:
    pass
  try:
    return float(s)
  except ValueError:
    pass
  return s
