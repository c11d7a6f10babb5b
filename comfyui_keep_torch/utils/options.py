"""The YAML experiment options (reference wm_basicsr/utils/options.py),
ported from comfyui_keep_tpu/utils/options.py: the ordered YAML load,
`--force_yml a:b=v` deep overrides with typed values, the debug-mode
frequency rewrites and parse_options' path layout.

The card machine has no pyyaml, so the YAML reader is the port's own. It
reads the subset that the repo's ymls and BasicSR-style configs use, and
resolves it as pyyaml's Loader (YAML 1.1) does:
  - block mappings and block sequences (`- `), a sequence under a key at
    the key's indentation;
  - flow mappings and flow sequences, nested, on one line or several;
  - plain, single-quoted and double-quoted scalars, and comments;
  - the `!!float`, `!!int` and `!!str` tags;
  - YAML 1.1 implicit resolution: `~`, `null` and the empty value; `yes`,
    `no`, `true`, `false`, `on`, `off` in their three cases; ints with `_`,
    `0x` and a leading 0 (octal); floats only with a dot, or `.inf` /
    `.nan`. So `1e4` is a string and `!!float 1e4` a float, as the shipped
    ymls expect;
  - the escapes `\\`, `\"`, `\n` and `\t` in double-quoted scalars.
Mappings come back as OrderedDicts in file order (a repeated key keeps its
first place and its last value), sequences as lists. Anything outside the
subset raises YAMLSubsetError naming the line: anchors and aliases, block
scalars (`|`, `>`), multi-line plain or quoted scalars, `? ` keys,
directives and document markers, other tags, timestamps, `<<` merges,
`0b` ints, base-60 numbers (`1:30`) and other escapes.

pin_platform_from_env is not ported: `--device` chooses the card.
"""
import argparse
import ast
import os
import random
import re
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple


class YAMLSubsetError(ValueError):
    """YAML outside the subset the reader takes, or malformed YAML."""


_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
# what pyyaml resolves as a number and the subset leaves out: 0b ints and
# base-60 ints and floats
_OUTSIDE_NUMBER_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*)$""", re.X)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                           re.X)
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t"}
_FLOW_END = ",[]{}"


def _construct_float(value: str) -> float:
    """pyyaml's construct_yaml_float."""
    value = value.replace("_", "").lower()
    sign = -1 if value[:1] == "-" else 1
    if value[:1] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    return sign * float(value)


def _construct_int(value: str) -> int:
    """pyyaml's construct_yaml_int."""
    value = value.replace("_", "")
    sign = -1 if value[:1] == "-" else 1
    if value[:1] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    return sign * int(value)


class _Scalar(str):
    """A scalar's text as written, before resolution; `plain` says whether
    it was unquoted (only plain scalars resolve implicitly)."""
    plain = True


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[List] = []     # [indent, content, line number]
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            if stripped.startswith("\t") or (
                    stripped and "\t" in body[:len(body) - len(stripped)]):
                raise self.error(no, "a tab in the indentation")
            content = self.strip_comment(stripped, no).rstrip()
            if not content:
                continue
            if content[0] == "%" or (content[:3] in ("---", "...") and (
                    len(content) == 3 or content[3] in " \t")):
                raise self.error(no, "directives and document markers are "
                                     "outside the subset")
            self.lines.append([len(body) - len(stripped), content, no])

    def error(self, no: int, what: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"{self.name}, line {no}: {what}")

    def strip_comment(self, s: str, no: int) -> str:
        """The line without its comment: a `#` at the start or after a
        blank, outside quoted scalars (a quote opens one only where a token
        starts)."""
        i, n = 0, len(s)
        while i < n:
            c = s[i]
            if c == "#" and (i == 0 or s[i - 1] in " \t"):
                return s[:i]
            if c in "'\"" and (i == 0 or s[i - 1] in " \t[{,"):
                i = self.quote_end(s, i, no)
            i += 1
        return s

    def quote_end(self, s: str, i: int, no: int) -> int:
        """Index of the quote that closes the one at s[i]."""
        q, j = s[i], i + 1
        while j < len(s):
            if q == "'" and s[j] == "'":
                if s[j + 1:j + 2] == "'":
                    j += 2
                    continue
                return j
            if q == '"':
                if s[j] == "\\":
                    j += 2
                    continue
                if s[j] == '"':
                    return j
            j += 1
        raise self.error(no, "a quoted scalar that does not close on its "
                             "line (multi-line scalars are outside the "
                             "subset)")

    # -- block structure -------------------------------------------------

    def parse(self):
        if not self.lines:
            return None
        value, i = self.node(0, self.lines[0][0])
        if i < len(self.lines):
            raise self.error(self.lines[i][2], "unexpected indentation")
        return value

    def node(self, i: int, indent: int) -> Tuple[Any, int]:
        """The node whose first line is lines[i], at `indent`; returns it
        and the index of the line after it."""
        content, no = self.lines[i][1], self.lines[i][2]
        if content == "-" or content.startswith("- "):
            return self.block_sequence(i, indent)
        if self.key_split(content, no) is not None:
            return self.block_mapping(i, indent)
        value, i = self.inline(i)
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise self.error(self.lines[i][2], "a multi-line plain scalar "
                                               "is outside the subset")
        return value, i

    def block_sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines) and self.lines[i][0] == indent:
            line = self.lines[i]
            if not (line[1] == "-" or line[1].startswith("- ")):
                break
            rest = line[1][1:].lstrip(" ")
            if not rest:
                i += 1
                if i < len(self.lines) and self.lines[i][0] > indent:
                    value, i = self.node(i, self.lines[i][0])
                else:
                    value = None
            else:
                # the entry's content as a line of its own at its column
                line[0] = indent + len(line[1]) - len(rest)
                line[1] = rest
                value, i = self.node(i, line[0])
            out.append(value)
        return out, self.check_end(i, indent)

    def block_mapping(self, i: int, indent: int) -> Tuple[OrderedDict, int]:
        pairs = []
        while i < len(self.lines) and self.lines[i][0] == indent:
            line = self.lines[i]
            no = line[2]
            split = self.key_split(line[1], no)
            if split is None:
                if line[1] == "-" or line[1].startswith("- "):
                    break
                raise self.error(no, "a mapping key without its `:`")
            key_text, rest = split
            key = self.resolve(self.scalar_token(key_text, no), no, key=True)
            if rest:
                line[0], line[1] = indent + len(line[1]) - len(rest), rest
                if rest == "-" or rest.startswith("- "):
                    raise self.error(no, "a block sequence on its key's "
                                         "line")
                if self.key_split(rest, no) is not None:
                    raise self.error(no, "a mapping value on its key's line")
                value, i = self.inline(i)
                if i < len(self.lines) and self.lines[i][0] > indent:
                    raise self.error(self.lines[i][2],
                                     "a multi-line plain scalar is outside "
                                     "the subset")
            else:
                i += 1
                nxt = self.lines[i] if i < len(self.lines) else None
                if nxt is not None and nxt[0] > indent:
                    value, i = self.node(i, nxt[0])
                elif nxt is not None and nxt[0] == indent and (
                        nxt[1] == "-" or nxt[1].startswith("- ")):
                    value, i = self.block_sequence(i, indent)
                else:
                    value = None
            pairs.append((key, value))
        return OrderedDict(pairs), self.check_end(i, indent)

    def check_end(self, i: int, indent: int) -> int:
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise self.error(self.lines[i][2], "unexpected indentation")
        return i

    def key_split(self, s: str, no: int) -> Optional[Tuple[str, str]]:
        """(key text, value text) where `s` is `key: value` (a `:` followed
        by a blank or the end, outside quotes and brackets), else None."""
        if s[0] in "[{":
            return None
        i, depth = 0, 0
        if s[0] in "'\"":
            i = self.quote_end(s, 0, no) + 1
        while i < len(s):
            c = s[i]
            if c in "'\"" and s[i - 1] in " \t[{,":
                i = self.quote_end(s, i, no)
            elif c in "[{" and (i == 0 or s[i - 1] in " \t[{,"):
                depth += 1
            elif c in "]}" and depth:
                depth -= 1
            elif c == ":" and not depth and (i + 1 == len(s)
                                             or s[i + 1] in " \t"):
                return s[:i].rstrip(), s[i + 1:].strip()
            i += 1
        return None

    def scalar_token(self, s: str, no: int) -> _Scalar:
        """A key, which is a plain or a quoted scalar."""
        if s.startswith(("'", '"')):
            value, end = self.quoted(s, 0, no)
            if s[end:].strip():
                raise self.error(no, "text after a quoted key")
            return value
        if s.startswith(("[", "{")):
            raise self.error(no, "a collection as a mapping key")
        if s[:2] == "? " or s == "?":
            raise self.error(no, "`? ` keys are outside the subset")
        self.check_plain(s, no)
        return _Scalar(s)

    def inline(self, i: int) -> Tuple[Any, int]:
        """The value written on lines[i] (a flow collection may go on over
        the following lines); returns it and the next line's index."""
        text, no = self.lines[i][1], self.lines[i][2]
        i += 1
        tag = None
        if text.startswith("!"):
            tag, _, text = text.partition(" ")
            text = text.lstrip(" ")
            self.check_tag(tag, no)
        if text.startswith(("[", "{")):
            while not self.balanced(text, no):
                if i >= len(self.lines):
                    raise self.error(no, "a flow collection that does not "
                                         "close")
                text += " " + self.lines[i][1]
                i += 1
            if tag is not None:
                raise self.error(no, f"the tag {tag} on a collection")
            value, end = self.flow(text, 0, no)
            if text[end:].strip():
                raise self.error(no, "text after a flow collection")
            return value, i
        if text.startswith(("'", '"')):
            value, end = self.quoted(text, 0, no)
            if text[end:].strip():
                raise self.error(no, "text after a quoted scalar")
        else:
            self.check_plain(text, no)
            value = _Scalar(text)
        return self.resolve(value, no, tag=tag), i

    def balanced(self, s: str, no: int) -> bool:
        depth, i = 0, 0
        while i < len(s):
            c = s[i]
            if c in "'\"" and (i == 0 or s[i - 1] in " \t[{,:"):
                i = self.quote_end(s, i, no)
            elif c in "[{":
                depth += 1
            elif c in "]}":
                depth -= 1
            i += 1
        return depth <= 0

    def check_tag(self, tag: str, no: int):
        if tag not in ("!!float", "!!int", "!!str"):
            raise self.error(no, f"the tag {tag} is outside the subset "
                                 "(!!float, !!int, !!str)")

    def check_plain(self, s: str, no: int):
        if not s:
            return
        c = s[0]
        if c == "&" or c == "*":
            raise self.error(no, "anchors and aliases are outside the subset")
        if c in "|>":
            raise self.error(no, "block scalars are outside the subset")
        if c in "%@`":
            raise self.error(no, f"a plain scalar cannot start with {c}")
        if c in ",]}" or s in ("-", "?", ":") or s[:2] in ("- ", "? ",
                                                            ": "):
            raise self.error(no, f"a plain scalar cannot start with {c}")
        if c == "!":
            raise self.error(no, "a tag without a value")
        if ": " in s or s.endswith(":") or " #" in s:
            raise self.error(no, "a mapping value where a scalar was "
                                 "expected")

    # -- scalars ---------------------------------------------------------

    def quoted(self, s: str, i: int, no: int) -> Tuple[_Scalar, int]:
        """The quoted scalar at s[i] and the index after its closing
        quote."""
        end = self.quote_end(s, i, no)
        body = s[i + 1:end]
        if s[i] == "'":
            text = body.replace("''", "'")
        else:
            out, j = [], 0
            while j < len(body):
                c = body[j]
                if c != "\\":
                    out.append(c)
                    j += 1
                    continue
                e = body[j + 1:j + 2]
                if e not in _ESCAPES:
                    raise self.error(no, f"the escape \\{e} is outside the "
                                         "subset (\\\\, \\\", \\n, \\t)")
                out.append(_ESCAPES[e])
                j += 2
            text = "".join(out)
        value = _Scalar(text)
        value.plain = False
        return value, end + 1

    def resolve(self, value: _Scalar, no: int, tag: Optional[str] = None,
                key: bool = False):
        """The Python value of a scalar, as pyyaml's Loader constructs it."""
        try:
            if tag == "!!str":
                return str(value)
            if tag == "!!float":
                return _construct_float(value)
            if tag == "!!int":
                return _construct_int(value)
        except (ValueError, IndexError):
            raise self.error(no, f"{tag} {value!r} is not a number") \
                from None
        if not value.plain:
            return str(value)
        if _BOOL_RE.match(value):
            return _BOOL[value.lower()]
        if _OUTSIDE_NUMBER_RE.match(value):
            raise self.error(no, f"{value!r} (a 0b int or a base-60 number) "
                                 "is outside the subset")
        if value[:1] and value[0] in "-+0123456789." and _FLOAT_RE.match(
                value):
            return _construct_float(value)
        if value[:1] and value[0] in "-+0123456789" and _INT_RE.match(value):
            return _construct_int(value)
        if _NULL_RE.match(value):
            return None
        if _TIMESTAMP_RE.match(value):
            raise self.error(no, f"the timestamp {value!r} is outside the "
                                 "subset")
        if value in ("<<", "="):
            raise self.error(no, f"{value!r} (merge and value keys) is "
                                 "outside the subset")
        return str(value)

    # -- flow collections ------------------------------------------------

    def skip(self, s: str, i: int) -> int:
        while i < len(s) and s[i] in " \t":
            i += 1
        return i

    def flow(self, s: str, i: int, no: int) -> Tuple[Any, int]:
        """The flow node at s[i] (after blanks) and the index after it."""
        i = self.skip(s, i)
        c = s[i:i + 1]
        if c == "[":
            out, i = [], self.skip(s, i + 1)
            while s[i:i + 1] != "]":
                value, i = self.flow_entry(s, i, no)
                if s[i:i + 1] == ":":
                    raise self.error(no, "a single-pair mapping in a flow "
                                         "sequence is outside the subset")
                out.append(value)
                i = self.flow_next(s, i, "]", no)
            return out, i + 1
        if c == "{":
            pairs, i = [], self.skip(s, i + 1)
            while s[i:i + 1] != "}":
                key, i = self.flow_entry(s, i, no, key=True)
                value = None
                if s[i:i + 1] == ":":
                    i = self.skip(s, i + 1)
                    if s[i:i + 1] not in (",", "}"):
                        value, i = self.flow_entry(s, i, no)
                pairs.append((key, value))
                i = self.flow_next(s, i, "}", no)
            return OrderedDict(pairs), i + 1
        raise self.error(no, "a flow collection was expected")

    def flow_next(self, s: str, i: int, close: str, no: int) -> int:
        i = self.skip(s, i)
        if s[i:i + 1] == ",":
            return self.skip(s, i + 1)
        if s[i:i + 1] != close:
            raise self.error(no, f"a `,` or `{close}` was expected in a "
                                 "flow collection")
        return i

    def flow_entry(self, s: str, i: int, no: int,
                   key: bool = False) -> Tuple[Any, int]:
        i = self.skip(s, i)
        c = s[i:i + 1]
        if c in ("[", "{"):
            if key:
                raise self.error(no, "a collection as a mapping key")
            value, i = self.flow(s, i, no)
            return value, self.skip(s, i)
        tag = None
        if c == "!":
            j = i
            while j < len(s) and s[j] not in " \t" + _FLOW_END:
                j += 1
            tag = s[i:j]
            self.check_tag(tag, no)
            i = self.skip(s, j)
            c = s[i:i + 1]
            if c in ("[", "{"):
                raise self.error(no, f"the tag {tag} on a collection")
        if c in ("'", '"'):
            value, i = self.quoted(s, i, no)
        else:
            j = i
            while j < len(s):
                if s[j] in _FLOW_END:
                    break
                if s[j] == ":" and (j + 1 == len(s)
                                    or s[j + 1] in " \t" + _FLOW_END):
                    break
                if s[j] == "?":
                    raise self.error(no, "a `?` in a flow collection is "
                                         "outside the subset")
                j += 1
            text = s[i:j].rstrip()
            if not text and tag is None:
                if key and s[j:j + 1] == ":":
                    return None, j
                raise self.error(no, "an empty entry in a flow collection")
            if text:
                self.check_plain(text, no)
            value, i = _Scalar(text), j
        return self.resolve(value, no, tag=tag, key=key), self.skip(s, i)


def yaml_load(f: str):
    """The YAML file at path `f` (or, when no such file exists, the YAML
    text `f` itself) as Python values: OrderedDicts in file order, lists,
    str, int, float, bool and None, as pyyaml's Loader gives them."""
    if os.path.isfile(f):
        with open(f, encoding="utf-8") as fh:
            return _Reader(fh.read(), f).parse()
    return _Reader(f, "<string>").parse()


def _postprocess_yml_value(value: str) -> Any:
    """Typed parsing of CLI override values (options.py:74-95)."""
    if value == "~" or value.lower() == "none":
        return None
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    if value.startswith("[") or value.startswith("{"):
        return ast.literal_eval(value)
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def apply_force_yml(opt: Dict, overrides):
    """`train:ema_decay=0.999`-style deep overrides."""
    for entry in overrides or ():
        keys, value = entry.split("=", 1)
        value = _postprocess_yml_value(value)
        node = opt
        parts = keys.split(":")
        for k in parts[:-1]:
            node = node[k]
        node[parts[-1]] = value
    return opt


def set_debug(opt: Dict):
    """Debug mode rewrites the frequencies (options.py: debug handling)."""
    if "train" in opt:
        opt["train"]["total_iter"] = min(opt["train"].get("total_iter", 8), 8)
    if "logger" in opt:
        opt["logger"]["print_freq"] = 1
        opt["logger"]["save_checkpoint_freq"] = 8
    if "val" in opt:
        opt["val"]["val_freq"] = 8
    return opt


def check_device(device: str) -> str:
    """`device` if the process can use it: a "cuda" device needs a card."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is visible "
                           "(pass --device cpu to run on the CPU)")
    return device


def parse_options(root_path: str = ".", is_train: bool = True, args=None):
    """(opt, parsed arguments) from the command line: -opt the YAML,
    --force_yml overrides, --debug, --auto_resume, --seed (written into
    manual_seed; without it and the yml's, a random one), --launcher
    torch (joins torch.distributed from torchrun's environment,
    parallel/mesh.py:init_distributed) and --device (default "cuda",
    which raises without a card). opt["path"] gains the experiment's
    layout under root_path/experiments (training) or root_path/results
    (testing)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True,
                        help="config YAML path")
    parser.add_argument("--launcher", choices=["none", "torch"],
                        default="none")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--force_yml", nargs="+", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="the torch device to run on (cuda, cuda:N or "
                             "cpu)")
    parsed = parser.parse_args(args)
    check_device(parsed.device)

    opt = yaml_load(parsed.opt)
    apply_force_yml(opt, parsed.force_yml)
    opt["auto_resume"] = parsed.auto_resume
    opt["is_train"] = is_train
    if parsed.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]
        set_debug(opt)

    if parsed.seed is not None:
        # --seed wins over the yml's manual_seed (the JAX package keeps the
        # yml's)
        opt["manual_seed"] = parsed.seed
    elif opt.get("manual_seed") is None:
        opt["manual_seed"] = random.randint(1, 10000)

    if parsed.launcher == "torch":
        from comfyui_keep_torch.parallel.mesh import init_distributed
        init_distributed(device=parsed.device)

    # path layout
    name = opt["name"]
    exp_root = os.path.join(root_path, "experiments" if is_train
                            else "results", name)
    opt.setdefault("path", {})
    opt["path"].update({
        "experiments_root": exp_root,
        "models": os.path.join(exp_root, "models"),
        "training_states": os.path.join(exp_root, "training_states"),
        "log": exp_root,
        "visualization": os.path.join(exp_root, "visualization"),
    })
    return opt, parsed
