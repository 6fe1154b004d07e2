"""The port's YAML reader and config loader (hyvideo_prfl_torch/configs).

The card's machine has no pyyaml, so the port reads ``configs/*.yaml`` with
its own reader. Here every published config is read by it and by
``yaml.safe_load`` (the tree and every type must agree: the loader's
number coercion depends on which scalars are strings), the port's
``load_config`` is held to the JAX package's, and the reader must refuse
what lies outside its subset rather than guess.
"""

import math
import os
import subprocess
import sys

import pytest
import yaml

from hyvideo_prfl_torch.configs import config as tconfig
from hyvideo_prfl_torch.configs import yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs")) if f.endswith(".yaml"))


def _same(a, b) -> bool:
    """Equal trees with equal types all the way down (True is not 1, 1.0 is
    not 1), keys in the same order."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return (len(a) == len(b) and all(_same(ka, kb) and _same(a[ka], b[kb])
                                         for ka, kb in zip(a, b)))
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _plain(tree):
    """An AttrDict tree as plain dicts and lists."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


def test_every_published_config_is_covered():
    assert len(CONFIGS) == 16, CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_reader_matches_safe_load(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        text = f.read()
    assert _same(yaml_lite.loads(text, name), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: 1e-5\nb: 1.0e+5\nc: 1.0e5\nd: 0.\ne: .5\nf: -.5\ng: 5.e-3\n",
    "a: 017\nb: 08\nc: 0x1F\nd: 0b101\ne: 1_000\nf: 1:30\ng: 1:30.5\nh: -0\ni: +1\n",
    "a: yes\nb: No\nc: ON\nd: off\ne: True\nf: ~\ng:\nh: null\ni: .inf\nj: -.INF\n",
    "a: 'it''s'\nb: \"x\\ty\\u00e9\"\nc: b c # comment\nd: b#c\ne: x:y\nf: http://x/y\n",
    "1: x\ntrue: y\nnull: z\n\"k: q\": 2\n",
    "a: [1, [2, 3], 'x', \"y\", ]\nb: []\nc:\n- 1\n- [2]\nd:\n  e:\n    - x # c\n  f: 2\n",
    "- 1\n- two\n- [3.0, null]\n",
    "", "# only a comment\n", "scalar\n",
], ids=["floats", "ints", "bools-nulls", "strings", "keys", "lists", "top-list", "empty",
        "comment", "top-scalar"])
def test_reader_types_scalars_as_safe_load(text):
    assert _same(yaml_lite.loads(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n", "a: |\n  block\n", "a: >\n  folded\n", "a:\t1\n",
    "a:\n\t- 1\n", "a: {b: 1}\n", "a: [1, {b: 2}]\n", "a:\n  - b: 1\n", "a: !!str 1\n",
    "---\na: 1\n", "a: 2001-12-14\n", "<<: {}\n", "a: 'open\n", "a: [1, 2\n",
    "a:\n  multi\n  line\n",
], ids=["anchor", "literal-block", "folded-block", "tab", "tab-indent", "flow-mapping",
        "flow-mapping-in-list", "mapping-in-sequence", "tag", "document-marker", "timestamp",
        "merge-key", "open-quote", "open-list", "multi-line-scalar"])
def test_reader_refuses_what_it_does_not_take(text):
    with pytest.raises(yaml_lite.YamlError):
        yaml_lite.loads(text)


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_coerces_as_before(name):
    # the loader over the reader's tree equals the loader over pyyaml's
    path = os.path.join(REPO, "configs", name)
    with open(path) as f:
        want = tconfig.config_from_dict(yaml.safe_load(f))
    assert _same(_plain(tconfig.load_config(path)), _plain(want))


def test_load_config_matches_the_jax_package():
    # hyvideo_prfl_tpu/configs/__init__.py imports the models (flax), so the
    # reference loader is imported here, not at module level. The port's
    # defaults are the JAX package's, copied: no difference by design.
    from hyvideo_prfl_tpu.configs import config as jconfig

    assert _same(_plain(tconfig.default_config()), _plain(jconfig.default_config()))
    for name in CONFIGS:
        path = os.path.join(REPO, "configs", name)
        assert _same(_plain(tconfig.load_config(path)), _plain(jconfig.load_config(path))), name


def test_load_config_needs_no_yaml():
    code = ("import sys\n"
            "sys.modules['yaml'] = None\n"
            "from hyvideo_prfl_torch.configs import load_config\n"
            "cfg = load_config('configs/train_prfl_t2v_480.yaml')\n"
            "assert cfg.optimizer.learning_rate == 5e-6\n"
            "assert cfg.lrm.query_attention.dropout == 0.0\n"
            "assert cfg.train.gradient_accumulation_steps == 5\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
