"""Config loading and experiment provenance, without pyyaml.

Port of ``diffuscene_tpu/utils/config.py`` (reference
``scripts/training_utils.py:15-52``).  The machine with the card has no
pyyaml, so :func:`parse_yaml` reads the subset of YAML that
``configs/**/*.yaml`` use, with YAML 1.1's plain-scalar rules as
``yaml.safe_load`` applies them:

- block maps (``key: value``, ``key:`` followed by an indented block or by
  a list at the key's own indent) and block lists of scalars (``- item``);
- scalars: null (``~``, ``null``, empty), bools (true/false, yes/no, on/off
  in their three spellings), decimal ints, floats with a dot (``1.0e-4``;
  ``1e-4`` without a dot is a string, as in YAML 1.1), ``.inf``, ``.nan``,
  and plain strings;
- ``#`` comments.

Anything else (quotes, flow collections, anchors, tags, block scalars,
documents, tabs, lists of maps, octal or hex ints, timestamps) raises
``ValueError`` with the line.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
from typing import Any, Dict, List, Tuple

import torch

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# plain scalars that YAML 1.1 would read as something this reader does not make
_UNSUPPORTED = re.compile(r"[-+]?0[0-7_]+$|[-+]?0[xob]|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|=$|<<$")
_INDICATORS = tuple("[]{},#&*!|>'\"%@`")
_KEY = re.compile(r"([^\s:#-][^:#]*?|-[^\s:#][^:#]*?)\s*:(?:\s+(.*))?$")

Line = Tuple[int, str, int]   # indent, content, line number


def _scalar(text: str, lineno: int) -> Any:
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    if text.startswith(_INDICATORS) or _UNSUPPORTED.match(text) or ": " in text:
        raise ValueError(f"line {lineno}: unsupported YAML scalar {text!r}")
    return text


def _lines(text: str) -> List[Line]:
    out = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = raw.split(" #", 1)[0] if not raw.lstrip().startswith("#") else ""
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t") or "\t" in body[: len(body) - len(stripped)]:
            raise ValueError(f"line {lineno}: tabs in indentation")
        if stripped.rstrip() in ("---", "..."):
            raise ValueError(f"line {lineno}: YAML documents are not supported")
        out.append((len(body) - len(stripped), stripped.rstrip(), lineno))
    return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: List[Line], pos: int, indent: int) -> Tuple[Any, int]:
    if _is_item(lines[pos][1]):
        return _list(lines, pos, indent)
    return _map(lines, pos, indent)


def _list(lines: List[Line], pos: int, indent: int) -> Tuple[list, int]:
    out = []
    while pos < len(lines) and lines[pos][0] == indent and _is_item(lines[pos][1]):
        _, content, lineno = lines[pos]
        item = content[1:].strip()
        if not item or _KEY.match(item) or _is_item(item):
            raise ValueError(f"line {lineno}: only lists of scalars are supported")
        out.append(_scalar(item, lineno))
        pos += 1
    return out, pos


def _map(lines: List[Line], pos: int, indent: int) -> Tuple[dict, int]:
    out: Dict[Any, Any] = {}
    while pos < len(lines) and lines[pos][0] == indent:
        _, content, lineno = lines[pos]
        m = _KEY.match(content)
        if not m:
            raise ValueError(f"line {lineno}: expected 'key: value', got {content!r}")
        key = _scalar(m.group(1), lineno)
        if key in out:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        value = m.group(2)
        pos += 1
        if value is not None and value.strip():
            out[key] = _scalar(value.strip(), lineno)
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _block(lines, pos, lines[pos][0])
        elif pos < len(lines) and lines[pos][0] == indent and _is_item(lines[pos][1]):
            out[key], pos = _list(lines, pos, indent)
        else:
            out[key] = None
    if pos < len(lines) and lines[pos][0] > indent:
        raise ValueError(f"line {lines[pos][2]}: unexpected indent")
    return out, pos


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = _lines(text)
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"line {lines[pos][2]}: unexpected dedent or content")
    return value


_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "f32": torch.float32}


def as_dtype(name):
    """A config's dtype name ("bfloat16", "bf16", "float32", "f32") -> the
    torch dtype; None and torch dtypes pass through."""
    return _DTYPES[name] if isinstance(name, str) else name


def _plain(value: Any) -> str:
    """``value`` as a plain scalar that :func:`parse_yaml` reads back equal."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        mantissa, e, exponent = repr(value).partition("e")
        if "." not in mantissa:        # 1e-05 reads as a string without the dot
            mantissa += ".0"
        return mantissa + e + exponent
    text = str(value)
    if _scalar_or_none(text) != value:
        raise ValueError(f"{value!r} is not a plain YAML scalar this reader reads back")
    return text


def _scalar_or_none(text: str) -> Any:
    try:
        return _scalar(text, 0)
    except ValueError:
        return None


def _dump(value: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    for key, v in value.items():
        if isinstance(v, dict) and v:
            out.append(f"{pad}{_plain(key)}:")
            _dump(v, indent + 2, out)
        elif isinstance(v, (list, tuple)) and v:
            out.append(f"{pad}{_plain(key)}:")
            out.extend(f"{pad}- {_plain(item)}" for item in v)
        elif isinstance(v, (dict, list, tuple)):
            raise ValueError(f"{key!r}: an empty {type(v).__name__} has no block form")
        else:
            out.append(f"{pad}{_plain(key)}: {_plain(v)}")


def dump_yaml(config: Dict[str, Any]) -> str:
    """A nested map of scalars and lists of scalars as YAML in the subset
    :func:`parse_yaml` reads, which reads it back equal (checked here:
    a value it would read otherwise raises ``ValueError``)."""
    lines: List[str] = []
    _dump(config, 0, lines)
    text = "\n".join(lines) + "\n"
    if parse_yaml(text) != config:
        raise ValueError("the config does not read back equal from its YAML")
    return text


def load_config(config_file: str) -> Dict[str, Any]:
    with open(config_file, "r") as f:
        return parse_yaml(f.read())


def save_experiment_params(args, experiment_tag: str, directory: str):
    """Dump the arguments, the git commit and the config to params.json."""
    params = {k: str(v) for k, v in vars(args).items()}
    git_head_hash = "unknown"
    try:
        git_head_hash = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=os.path.dirname(os.path.realpath(__file__)),
            stderr=subprocess.DEVNULL,
        ).strip().decode()
    except (subprocess.CalledProcessError, OSError):
        pass
    params["git-commit"] = git_head_hash
    params["experiment_tag"] = experiment_tag
    for k, v in list(params.items()):
        if v == "":
            params[k] = None
    if getattr(args, "config_file", None):
        params.update(load_config(args.config_file))
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "params.json"), "w") as f:
        json.dump(params, f, indent=4)
