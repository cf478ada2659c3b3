"""Dataset yamls and image files on disk (counterpart of the JAX package's
``data/utils.py``): ``check_det_dataset``, ``check_cls_dataset``,
``img2label_paths``, the image scan of JAX's ``YOLODataset._scan``, and a
reader of the yaml subset that dataset yamls use (the port imports no
``yaml``).

Unlike JAX's, ``check_det_dataset`` never downloads: a ``val`` split that
is not on disk raises ``FileNotFoundError`` naming it (and the yaml's
``download`` entry, which is not run).

``load_yaml`` / ``parse_yaml`` read block maps nested by indentation,
block lists (``- item``), one-line flow lists (``[0, 2, 1]``, nested ones
too), plain, single- and double-quoted scalars and ``#`` comments. Scalars
resolve as ``yaml.safe_load`` resolves them (YAML 1.1: ``yes`` / ``no`` /
``on`` / ``off`` are booleans, ``~`` and ``null`` None, ints in bases 2, 8,
10 and 16, floats with a dot or ``.inf`` / ``.nan``; keys too, so ``0:`` is
the int 0). Anything else (flow maps, anchors and aliases, tags, block
scalars, multi-line scalars, maps inside list items, several documents)
raises ``YamlSubsetError`` with its line number.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Tuple, Union

IMG_FORMATS = (".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp")


class YamlSubsetError(ValueError):
    """A yaml construct outside the subset, or malformed; names its line."""


# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_UNSUPPORTED_START = ("&", "*", "!", "|", ">", "{", "%", "@", "`")


def _sexagesimal(s: str, cast):
    sign = -1 if s[0] == "-" else 1
    digits = [cast(p) for p in s.lstrip("+-").split(":")]
    value, base = 0, 1
    for d in reversed(digits):
        value += d * base
        base *= 60
    return sign * value


def _resolve_int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    body = s.lstrip("+-")
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body[0] == "0":
        return sign * int(body, 8)
    if ":" in body:
        return _sexagesimal(s, int)
    return sign * int(body)


def _resolve_float(s: str) -> float:
    s = s.replace("_", "").lower()
    if s in (".nan",):
        return float("nan")
    if s.lstrip("+-") == ".inf":
        return float("-inf") if s[0] == "-" else float("inf")
    if ":" in s:
        return float(_sexagesimal(s, float))
    return float(s)


def _plain(s: str, line: int):
    """A plain scalar as ``yaml.safe_load`` resolves it."""
    if s.startswith(_UNSUPPORTED_START):
        raise YamlSubsetError(f"line {line}: {s[0]!r} (anchors, aliases, tags, block scalars, "
                              "flow maps) is outside the dataset yaml subset")
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s in _TRUE
    if _INT.match(s):
        return _resolve_int(s)
    if _FLOAT.match(s):
        return _resolve_float(s)
    return s


def _quoted(s: str, line: int) -> Tuple[str, str]:
    """A quoted scalar at the start of ``s`` -> (its value, the rest)."""
    q = s[0]
    i, out = 1, []
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), s[i + 1:]
        if q == '"' and c == "\\":
            esc = s[i + 1:i + 2]
            table = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0",
                     "r": "\r", " ": " "}
            if esc not in table:
                raise YamlSubsetError(f"line {line}: escape \\{esc} is outside the subset")
            out.append(table[esc])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), s[i + 1:]
        out.append(c)
        i += 1
    raise YamlSubsetError(f"line {line}: unterminated {q}-quoted scalar (multi-line scalars are "
                          "outside the subset)")


def _strip_comment(text: str) -> str:
    """``text`` without a ``#`` comment (one at the start or after a blank,
    outside quotes)."""
    q = None
    for i, c in enumerate(text):
        if q:
            if c == q:
                q = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[,:-"):
            q = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _flow_list(s: str, line: int) -> Tuple[list, str]:
    """A flow list at the start of ``s`` (``[``) -> (its items, the rest)."""
    items, i = [], 1
    while True:
        rest = s[i:].lstrip()
        i = len(s) - len(rest)
        if rest.startswith("]"):
            if items and s[:i].rstrip().endswith(","):
                pass  # a trailing comma, as yaml allows
            return items, s[i + 1:]
        if not rest:
            raise YamlSubsetError(f"line {line}: unterminated flow list (a list must close on "
                                  "its line)")
        if rest[0] == "[":
            value, after = _flow_list(rest, line)
        elif rest[0] in "'\"":
            value, after = _quoted(rest, line)
        else:
            m = re.match(r"[^,\]]*", rest)
            token = m.group(0).strip()
            if ": " in token or token.endswith(":"):
                raise YamlSubsetError(f"line {line}: a map inside a flow list is outside the "
                                      "subset")
            value, after = _plain(token, line), rest[m.end():]
        items.append(value)
        after = after.lstrip()
        if after.startswith(","):
            after = after[1:]
        elif not after.startswith("]"):
            raise YamlSubsetError(f"line {line}: expected ',' or ']' in a flow list")
        i = len(s) - len(after)


def _value(s: str, line: int):
    """An inline value: a flow list, a quoted or a plain scalar."""
    s = s.strip()
    if s.startswith("["):
        value, rest = _flow_list(s, line)
    elif s[:1] in ("'", '"'):
        value, rest = _quoted(s, line)
    else:
        if ": " in s or s.endswith(":"):
            raise YamlSubsetError(f"line {line}: a map on one line is outside the subset")
        return _plain(s, line)
    if rest.strip():
        raise YamlSubsetError(f"line {line}: unexpected text after a value: {rest.strip()!r}")
    return value


def _split_key(s: str, line: int):
    """``key: value`` -> (key, value text); None when ``s`` is no map
    entry."""
    if s[:1] in ("'", '"'):
        key, rest = _quoted(s, line)
        if not (rest.startswith(":") and (len(rest) == 1 or rest[1] == " ")):
            return None
        return key, rest[1:]
    m = re.match(r"([^'\"#\[\]{}][^#]*?):(?: (.*)|)$", s)
    if not m:
        return None
    return _plain(m.group(1).strip(), line), m.group(2) or ""


class _Lines:
    def __init__(self, text: str):
        self.items: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for n, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                raise YamlSubsetError(f"line {n}: a tab in the indentation")
            if stripped.startswith(("---", "...")) and len(body) == len(stripped):
                raise YamlSubsetError(f"line {n}: document markers are outside the subset")
            self.items.append((n, len(body) - len(stripped), stripped))


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: _Lines, i: int, indent: int):
    """The block node whose lines start at ``i`` at ``indent`` -> (value,
    the index after it)."""
    n, ind, content = lines.items[i]
    if _is_item(content):
        out = []
        while i < len(lines.items):
            n, ind, content = lines.items[i]
            if ind < indent or (ind == indent and not _is_item(content)):
                break
            if ind > indent or not _is_item(content):
                raise YamlSubsetError(f"line {n}: bad indentation in a list")
            rest = content[1:].strip()
            i += 1
            if rest:
                if rest.startswith("- ") or rest == "-" or _split_key(rest, n) is not None:
                    raise YamlSubsetError(f"line {n}: a map or list inline in a list item is "
                                          "outside the subset")
                out.append(_value(rest, n))
            elif i < len(lines.items) and lines.items[i][1] > indent:
                value, i = _block(lines, i, lines.items[i][1])
                out.append(value)
            else:
                out.append(None)
        return out, i
    out = {}
    while i < len(lines.items):
        n, ind, content = lines.items[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlSubsetError(f"line {n}: bad indentation")
        kv = _split_key(content, n)
        if kv is None:
            raise YamlSubsetError(f"line {n}: expected 'key: value' ({content!r})")
        key, rest = kv
        if key in out:
            raise YamlSubsetError(f"line {n}: duplicate key {key!r}")
        i += 1
        if rest.strip():
            out[key] = _value(rest, n)
        elif i < len(lines.items) and (lines.items[i][1] > indent or (
                lines.items[i][1] == indent and _is_item(lines.items[i][2]))):
            out[key], i = _block(lines, i, lines.items[i][1])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str):
    """The yaml subset of the module docstring -> Python values."""
    lines = _Lines(text)
    if not lines.items:
        return None
    first = lines.items[0]
    if first[1] != 0:
        raise YamlSubsetError(f"line {first[0]}: the document must start at column 0")
    if len(lines.items) == 1 and not _is_item(first[2]) and _split_key(first[2], first[0]) is None:
        return _value(first[2], first[0])
    value, i = _block(lines, 0, 0)
    if i != len(lines.items):
        raise YamlSubsetError(f"line {lines.items[i][0]}: unexpected text after the document")
    return value


def load_yaml(path: Union[str, Path]):
    """``parse_yaml`` of a file; an error names the file and line."""
    try:
        return parse_yaml(Path(path).read_text())
    except YamlSubsetError as e:
        raise YamlSubsetError(f"{path}: {e}") from None


def check_det_dataset(data) -> Dict:
    """A detect / segment / pose dataset yaml (or its dict) resolved: split
    paths made absolute against ``path`` (itself against the yaml's
    directory), ``names`` an index map (from a list, an index map or
    ``nc``), ``nc`` its length, ``val`` defaulting to ``test`` then
    ``train``. A yaml not found is looked up by name in ``DATASETS_DIR``. A
    ``val`` split missing on disk raises (nothing is downloaded)."""
    if isinstance(data, dict):
        d = dict(data)
        base = Path(d.get("path", "."))
    else:
        p = Path(data)
        if not p.exists():
            from ..cfg import DATASETS_DIR

            cand = DATASETS_DIR / p.name
            if not cand.exists():
                raise FileNotFoundError(f"dataset yaml not found: {data}")
            p = cand
        d = load_yaml(p)
        if not isinstance(d, dict):
            raise ValueError(f"{p}: a dataset yaml is a map")
        base = Path(d.get("path", p.parent))
        if not base.is_absolute():
            base = (p.parent / base).resolve()
    names = d.get("names")
    if isinstance(names, list):
        names = {i: n for i, n in enumerate(names)}
    elif isinstance(names, dict):
        names = {int(k): v for k, v in names.items()}
    elif "nc" in d:
        names = {i: f"class{i}" for i in range(int(d["nc"]))}
    else:
        raise KeyError("dataset yaml needs 'names' or 'nc'")
    d["names"] = names
    d["nc"] = len(names)
    for split in ("train", "val", "test"):
        v = d.get(split)
        if v is None:
            continue
        vp = Path(v)
        d[split] = str(vp if vp.is_absolute() else base / vp)
    if "val" not in d or d.get("val") is None:
        d["val"] = d.get("test") or d.get("train")
    val = d.get("val")
    if val and not Path(val).exists():
        note = " (its 'download' entry is not run: place the data there)" if d.get(
            "download") else ""
        raise FileNotFoundError(f"dataset split 'val' not found: {val}{note}")
    return d


def check_cls_dataset(data) -> Dict:
    """A classification root with ``train/`` and ``val/`` (or ``test/``,
    ``validation/``) folders of class folders; without ``train/`` the root
    is the train split, without a val folder the train split is the val
    one. ``names`` numbers the sorted class folders."""
    base = Path(data)
    if not base.exists():
        raise FileNotFoundError(f"classification dataset not found: {data}")
    train = base / "train" if (base / "train").exists() else base
    val = None
    for cand in ("val", "test", "validation"):
        if (base / cand).exists():
            val = base / cand
            break
    classes = sorted(d.name for d in train.iterdir() if d.is_dir())
    return {
        "train": str(train),
        "val": str(val or train),
        "names": {i: c for i, c in enumerate(classes)},
        "nc": len(classes),
    }


def img2label_paths(img_paths) -> List[str]:
    """``.../images/x.jpg`` -> ``.../labels/x.txt`` for each path (the last
    ``images`` directory of each)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(str(p).rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for p in img_paths]


def scan_images(img_path) -> List[str]:
    """The image files of a split (JAX ``YOLODataset._scan``): a directory
    (every file of ``IMG_FORMATS`` below it, sorted), a ``.txt`` list (one
    path a line, relative to the list's directory) or a file; a list or
    tuple of those, in order. Raises when nothing is found."""
    files: List[str] = []
    for p in img_path if isinstance(img_path, (list, tuple)) else [img_path]:
        p = Path(p)
        if p.is_dir():
            files += sorted(str(f) for f in p.rglob("*") if f.suffix.lower() in IMG_FORMATS)
        elif p.is_file() and p.suffix == ".txt":
            with open(p) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        files.append(line if os.path.isabs(line) else str(p.parent / line))
        elif p.is_file():
            files.append(str(p))
        else:
            raise FileNotFoundError(f"image path not found: {p}")
    if not files:
        raise FileNotFoundError(f"no images found in {img_path}")
    return files
