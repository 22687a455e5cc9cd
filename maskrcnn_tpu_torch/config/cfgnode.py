"""A yacs-compatible configuration node.

The reference framework configures everything through a yacs ``CfgNode``
(reference: maskrcnn_benchmark/config/defaults.py, yacs on pypi). yacs is not
available in this environment, so this is an independent, minimal
re-implementation of the subset of its behaviour the framework and its YAML
config files rely on:

  * attribute-style access (``cfg.MODEL.RPN.NMS_THRESH``)
  * ``merge_from_file`` / ``merge_from_other_cfg`` / ``merge_from_list``
  * type checking with the yacs coercions (list<->tuple, int->float,
    str<->unicode) on merge
  * ``freeze`` / ``defrost`` / ``is_frozen``
  * ``clone`` and ``dump`` (YAML round-trip)

Anything not listed above is intentionally not implemented.

PyTorch port copy of maskrcnn_tpu/config/cfgnode.py. One change, so that
the port runs where PyYAML is missing: the YAML is the port's own. Files
are read by ``load_yaml``, which takes the subset the config files are
written in (block mappings by indentation, comments, a scalar on its key's
line or on the next one; the scalars, flow lists and tuples decoded as
yacs decodes command-line values), and ``dump`` and the decoding of
command-line values are ``_yaml_lines`` and ``_decode_value``. For a tree
of scalars and sequences, as the configuration is, ``dump`` writes what
``yaml.safe_dump`` writes.
"""

import ast
import copy
import re

_VALID_TYPES = {tuple, list, str, int, float, bool, type(None)}


class CfgNode(dict):
    """Dict subclass with attribute access and yacs merge semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                "Attempted to set {} to {}, but CfgNode is immutable".format(
                    name, value
                )
            )
        self[name] = value

    def __setitem__(self, name, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                "Attempted to set {} to {}, but CfgNode is immutable".format(
                    name, value
                )
            )
        dict.__setitem__(self, name, value)

    # -- freezing ------------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self):
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value):
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # -- cloning / dumping ----------------------------------------------------
    def clone(self):
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    def _to_plain(self):
        out = {}
        for k, v in self.items():
            out[k] = v._to_plain() if isinstance(v, CfgNode) else v
        return out

    def dump(self):
        return "".join(line + "\n" for line in _yaml_lines(self._to_plain(), ""))

    def __str__(self):
        return self.dump()

    def __repr__(self):
        return "CfgNode({})".format(dict.__repr__(self))

    # -- merging ---------------------------------------------------------------
    def merge_from_file(self, cfg_filename):
        with open(cfg_filename, "r") as f:
            loaded = load_yaml(f.read())
        self._merge_dict(loaded, [])

    def merge_from_other_cfg(self, other):
        self._merge_dict(
            other._to_plain() if isinstance(other, CfgNode) else other, []
        )

    def merge_from_list(self, opts):
        if len(opts) % 2 != 0:
            raise ValueError("Override list has odd length: {}".format(opts))
        for full_key, v in zip(opts[0::2], opts[1::2]):
            node = self
            parts = full_key.split(".")
            for sub in parts[:-1]:
                if sub not in node:
                    raise KeyError("Non-existent key: {}".format(full_key))
                node = node[sub]
            key = parts[-1]
            if key not in node:
                raise KeyError("Non-existent key: {}".format(full_key))
            value = _decode_value(v)
            dict.__setitem__(
                node, key, _coerce(value, node[key], full_key)
            )

    def _merge_dict(self, d, key_path):
        for k, v in d.items():
            full_key = ".".join(key_path + [k])
            if k not in self:
                raise KeyError("Non-existent config key: {}".format(full_key))
            current = self[k]
            if isinstance(current, CfgNode):
                if not isinstance(v, dict):
                    raise ValueError(
                        "Cannot merge non-dict into config node {}".format(
                            full_key
                        )
                    )
                current._merge_dict(v, key_path + [k])
            else:
                # YAML parses "(32, 64)" as a string; decode literals like
                # yacs' _decode_cfg_value does.
                dict.__setitem__(self, k, _coerce(_decode_value(v), current, full_key))


_YAML_WORDS = {
    "true": True, "yes": True, "on": True, "false": False, "no": False, "off": False,
    "null": None, "~": None,
}
_PLAIN = re.compile(r"[A-Za-z_./][\w./-]*\Z")


_KEY_LINE = re.compile(r"([A-Za-z0-9_.-]+)\s*:(?:\s+(.*))?\Z")


def _uncomment(line):
    """The line without a trailing '#' comment (a '#' at the start or after
    a blank, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _yaml_value(text):
    """A scalar's text: quoted strings unquoted, the rest (numbers, words,
    flow lists, tuples) as written, for _decode_value."""
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return ast.literal_eval(text)
    return text


def load_yaml(text):
    """The nested dict of a config file in the YAML subset the configs use:
    block mappings by indentation, '#' comments, each value a scalar or flow
    list on its key's line or, indented, on the next line. Leaves are
    strings that _merge_dict decodes; a key with no value is None."""
    root = {}
    stack = [(0, root)]  # (indentation of its keys, mapping)
    open_key = None  # (mapping, key, indentation) of a key with no value yet
    for number, raw in enumerate(text.splitlines(), 1):
        line = _uncomment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        m = _KEY_LINE.match(body)
        if open_key is not None:
            mapping, key, key_indent = open_key
            open_key = None
            if indent > key_indent:
                if m is None:
                    mapping[key] = _yaml_value(body)
                    continue
                mapping[key] = {}
                stack.append((indent, mapping[key]))
        if m is None:
            raise ValueError("line {}: {!r} is not in the YAML subset of the config files"
                             .format(number, raw))
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError("line {}: bad indentation: {!r}".format(number, raw))
        key, value = m.group(1), m.group(2)
        if value:
            stack[-1][1][key] = _yaml_value(value.strip())
        else:
            stack[-1][1][key] = None
            open_key = (stack[-1][1], key, indent)
    return root


def _decode_value(v):
    """Parse a CLI override string into a python literal (yacs behaviour:
    ast.literal_eval first, which handles tuples; then YAML's words for
    booleans and null; else the string itself)."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        pass
    return _YAML_WORDS.get(v.lower(), v)


def _yaml_scalar(v):
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:  # YAML 1.1 floats need a dot: 1e-05 -> 1.0e-05
            r = r.replace("e", ".0e")
        return r
    if _PLAIN.match(v) and v.lower() not in _YAML_WORDS and v.lower() not in (".inf", ".nan"):
        return v
    return "'" + v.replace("'", "''") + "'"


def _yaml_lines(value, indent):
    """Block-style YAML of a plain dict, sorted keys, 2-space indent;
    sequences nested in a sequence are written in flow style."""
    if not value:
        return [indent + ("{}" if isinstance(value, dict) else "[]")]
    lines = []
    for k in sorted(value):
        v = value[k]
        if isinstance(v, dict) and v:
            lines.append("{}{}:".format(indent, k))
            lines.extend(_yaml_lines(v, indent + "  "))
        elif isinstance(v, (list, tuple)) and v:
            lines.append("{}{}:".format(indent, k))
            for item in v:
                text = ("[" + ", ".join(_yaml_scalar(x) for x in item) + "]"
                        if isinstance(item, (list, tuple)) else _yaml_scalar(item))
                lines.append("{}- {}".format(indent, text))
        elif isinstance(v, (dict, list, tuple)):
            lines.append("{}{}: {}".format(indent, k, "{}" if isinstance(v, dict) else "[]"))
        else:
            lines.append("{}{}: {}".format(indent, k, _yaml_scalar(v)))
    return lines


def _coerce(new, old, full_key):
    """Apply yacs type-coercion rules when replacing `old` with `new`."""
    if isinstance(new, dict):
        new = CfgNode(new)
    old_t, new_t = type(old), type(new)
    if old_t is new_t or old is None or new is None:
        return new
    # list <-> tuple
    if old_t is tuple and new_t is list:
        return tuple(new)
    if old_t is list and new_t is tuple:
        return list(new)
    # numeric promotion
    if old_t is float and new_t is int:
        return float(new)
    if old_t is int and new_t is float and float(int(new)) == new:
        return int(new)
    if old_t is float and new_t is bool:
        raise ValueError(
            "Type mismatch ({} vs {}) for key {}".format(old_t, new_t, full_key)
        )
    if isinstance(new, old_t):  # bool is subclass of int etc.
        return new
    raise ValueError(
        "Type mismatch ({} vs {}) with values ({} vs {}) for key {}".format(
            old_t, new_t, old, new, full_key
        )
    )
