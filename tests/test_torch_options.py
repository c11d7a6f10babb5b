"""The port's YAML options (comfyui_keep_torch/utils/options.py) against
the JAX package's (comfyui_keep_tpu/utils/options.py), whose reader is
pyyaml's Loader: the port's own reader gives the same values, the same
Python types and the same key order on every yml in options/ and on a
hypothesis corpus of the subset it reads; what lies outside the subset
raises naming its line; the overrides, the debug rewrites and
parse_options' layout equal JAX's on the same argv.
"""
import glob
import os
import random
from collections import OrderedDict

import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from comfyui_keep_tpu.utils import options as jopt
from comfyui_keep_torch.utils import options as topt
from comfyui_keep_torch.utils.options import YAMLSubsetError, yaml_load
from tests.torch_port_helpers import same_values as same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YMLS = sorted(glob.glob(os.path.join(REPO, "options", "*.yml")))


def pyyaml(text):
    return yaml.load(text, Loader=jopt.ordered_yaml()[0])


@pytest.mark.parametrize("path", YMLS, ids=os.path.basename)
def test_yaml_load_equals_pyyaml_on_the_shipped_ymls(path):
    with open(path) as f:
        ref = yaml.load(f, Loader=jopt.ordered_yaml()[0])
    ours = yaml_load(path)
    assert isinstance(ours, OrderedDict)
    assert same(ours, ref)
    assert same(yaml_load(open(path).read()), ref)    # the text itself


SCALARS = [
    "1e4", "!!float 1e4", "!!float 5e-5", "!!float 1", "!!int 42",
    "!!int 0x10", "!!str 123", "!!str yes", "!!float '1e-2'", "!!str",
    "1.5", "1.", ".5", "-2", "+3", "0", "-0", "0x1f", "017",
    "1_000", ".inf", "-.Inf", "+.INF", ".NaN", "1e-3",
    "1.0e+3", "1.0e3", "~", "null", "Null", "NULL", "", "yes", "Yes", "NO",
    "on", "Off", "True", "false", "y", "n", "'12'", '"3"', "'it''s'",
    '"tab\\there"', '"a\\\\b\\"c\\nd"', "abc", "a b  c", "path/to/x.pth",
    "http://host/x", "a:b", "v#1", "-x", "[]", "{}", "[1, 2.5, yes, ~]",
    "{a: 1, b: [x, 'y'], c}", "[[1, [2]], {k: {v: 1e4}}]", "[a,]",
]


@pytest.mark.parametrize("value", SCALARS)
def test_resolution_equals_pyyaml(value):
    """YAML 1.1 resolution as pyyaml's Loader gives it, one value at a
    time, as a mapping value and inside a block sequence."""
    for text in (f"key: {value}\n", f"- {value}\n- end\n"):
        assert same(yaml_load(text), pyyaml(text)), text


BAD = [
    ("a: 1\nb: &x 2\n", 2), ("a: 1\nb: *x\n", 2), ("a: |\n  text\n", 1),
    ("a: >\n  text\n", 1), ("? a\n: 1\n", 1), ("a: !!python/tuple [1]\n", 1),
    ("a: !!binary aGk=\n", 1), ("%YAML 1.1\na: 1\n", 1), ("---\na: 1\n", 1),
    ("a: 1\n...\n", 2), ("a: some\n  more\n", 2), ("a: 2001-12-14\n", 1),
    ("<<: {a: 1}\n", 1), ("a:\n\tb: 1\n", 2), ("a: 'open\n  shut'\n", 1),
    ("a: [1, 2\n", 1), ("a: b: c\n", 1), ("a: [x: 1]\n", 1),
    ("a: {b: &y 1}\n", 1), ("a: [? b]\n", 1), ("a: 1\nb: 0b101\n", 2),
    ("a: 1:30\n", 1), ("a: [1, -1:30.5]\n", 1), ('a: "\\u00e9"\n', 1),
    ('a: 1\nb: "\\x41"\n', 2), ('a: "\\0"\n', 1), ('a: "\\N"\n', 1),
    ("a: !!int 0b101\n", 1), ("a: !!float 1:30\n", 1),
]


@pytest.mark.parametrize("text,line", BAD)
def test_outside_the_subset_raises_naming_the_line(text, line):
    with pytest.raises(YAMLSubsetError, match=f"line {line}:"):
        yaml_load(text)


# -- the hypothesis corpus: documents of the subset, rendered in block and
# flow styles, with quotes, tags and comments, read by both readers ------

WORD = st.text("abcdefgxyz_-.0123456789", min_size=1, max_size=8).filter(
    lambda w: w[0] not in "-." and not w.endswith(".")
    and not w.startswith("0b"))     # 0b ints are outside the subset
TRICKY = st.sampled_from([
    "1e4", "1.5", "-2", "0x1f", "017", "1_000", ".inf", ".nan",
    "~", "null", "yes", "No", "on", "OFF", "true", "16", "0", "5e-5", "a b",
    "x.pth", "0.995", "-1", "+1"])
TAGGED = st.sampled_from([
    "!!float 1e4", "!!float 5e-5", "!!float 1e-2", "!!int 42",
    "!!int 0x10", "!!str 123", "!!str yes", "!!float 3"])


@st.composite
def scalar(draw, flow=False):
    kind = draw(st.sampled_from(["plain", "tricky", "single", "double",
                                 "tagged"]))
    if kind == "plain":
        return draw(WORD)
    if kind == "tricky":
        return draw(TRICKY)
    if kind == "tagged":
        return draw(TAGGED)
    text = draw(st.text("abc xyz:#,[]{}'\"\\-1.", max_size=8))
    if kind == "single":
        return "'" + text.replace("'", "''") + "'"
    return '"' + text.replace("\\", "\\\\").replace('"', '\\"') + '"'


KEYS = st.one_of(WORD, st.sampled_from(["yes", "1", "~", "'quoted key'",
                                        '"k: v"']))


def flow_node(depth):
    if depth == 0:
        return scalar(flow=True)
    inner = flow_node(depth - 1)
    return st.one_of(
        scalar(flow=True),
        st.lists(inner, max_size=3).map(lambda v: "[" + ", ".join(v) + "]"),
        st.lists(st.tuples(KEYS, inner), max_size=3).map(
            lambda kv: "{" + ", ".join(f"{k}: {v}" for k, v in kv) + "}"))


@st.composite
def block(draw, indent=0, depth=2):
    """Lines of a block mapping or sequence at `indent`."""
    pad = " " * indent
    lines = []
    seq = depth < 2 and draw(st.booleans())
    for _ in range(draw(st.integers(1, 3))):
        if draw(st.integers(0, 6)) == 0:
            lines.append(pad + "# a comment line")
        head = pad + "- " if seq else pad + draw(KEYS) + ":"
        choice = draw(st.integers(0, 3)) if depth else 0
        if choice <= 1:
            value = draw(scalar()) if choice == 0 else draw(flow_node(2))
            comment = " # trailing" if draw(st.booleans()) else ""
            lines.append(head + ("" if seq else " ") + value + comment)
        else:
            child = draw(block(indent + 2, depth - 1))
            if seq:
                lines.append(pad + "-")
            else:
                lines.append(head)
            lines.extend(child)
    return lines


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(block(0, 2))
def test_yaml_load_equals_pyyaml_on_the_subset(lines):
    text = "\n".join(lines) + "\n"
    try:
        ref = pyyaml(text)
    except yaml.YAMLError:
        with pytest.raises(YAMLSubsetError):
            yaml_load(text)
        return
    assert same(yaml_load(text), ref), text


# -- the options functions -------------------------------------------------

@pytest.mark.parametrize("value", [
    "~", "None", "none", "true", "False", "[1, 'a']", "{'a': 1}", "12",
    "-3", "1e4", "0.5", "abc", "/tmp/x.pth", "1_0"])
def test_postprocess_yml_value_equals_jax(value):
    ours, ref = topt._postprocess_yml_value(value), \
        jopt._postprocess_yml_value(value)
    assert ours == ref and type(ours) is type(ref)


FORCES = [
    ["train:ema_decay=0.999"],
    ["train:optim_g:lr=2e-4", "datasets:train:scale=1", "name=x"],
    ["network_g:ch_mult=[1, 2]", "logger={'print_freq': 1}",
     "path:pretrain_network_g=~"],
]


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("path", YMLS, ids=os.path.basename)
def test_apply_force_yml_and_set_debug_equal_jax(path, force):
    with open(path) as f:
        ref = yaml.load(f, Loader=jopt.ordered_yaml()[0])
    ours = yaml_load(path)
    try:
        jopt.apply_force_yml(ref, force)
    except KeyError:        # a path the yml lacks: the port raises alike
        with pytest.raises(KeyError):
            topt.apply_force_yml(ours, force)
        return
    topt.apply_force_yml(ours, force)
    assert same(ours, ref)
    assert same(topt.set_debug(ours), jopt.set_debug(ref))


ARGVS = [
    [], ["--debug"], ["--seed", "5"], ["--auto_resume"],
    ["--force_yml", "manual_seed=~", "train:total_iter=3"],
    ["--debug", "--force_yml", "name=debug_x"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "bare")
@pytest.mark.parametrize("is_train", [True, False])
def test_parse_options_equals_jax(tmp_path, argv, is_train):
    """The same opt (path layout, seed, debug name and rewrites) as JAX's
    parse_options on the same argv; the port's takes --device too. A
    random seed (manual_seed unset) is drawn from the same `random`
    state. --seed 5 is the one departure: it becomes manual_seed, where
    JAX keeps the yml's (0 here)."""
    yml = os.path.join(REPO, "options", "train_keep_stage3_gan.yml")
    full = ["-opt", yml] + argv
    random.seed(3)
    ref, ref_args = jopt.parse_options(str(tmp_path), is_train, full)
    random.seed(3)
    ours, args = topt.parse_options(str(tmp_path), is_train,
                                    full + ["--device", "cpu"])
    if "--seed" in argv:
        assert ref["manual_seed"] == 0 and ours["manual_seed"] == 5
        ref["manual_seed"] = 5
    assert same(ours, ref)
    assert args.device == "cpu" and args.launcher == "none"
    assert {k: v for k, v in vars(args).items() if k != "device"} == {
        k: v for k, v in vars(ref_args).items()}


def test_parse_options_device_cuda_needs_a_card(tmp_path):
    """--device defaults to cuda, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    yml = os.path.join(REPO, "options", "test_keep.yml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topt.parse_options(str(tmp_path), False, ["-opt", yml])
    with pytest.raises(SystemExit):     # JAX's launcher name is not taken
        topt.parse_options(str(tmp_path), False,
                           ["-opt", yml, "--launcher", "jax",
                            "--device", "cpu"])
