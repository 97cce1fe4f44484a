"""The port's lint engine and rules on synthetic sources.

The reference's `tests/test_lint_framework.py` is replayed against the
port (`replay`: its source with the package pointed at
`tidb_tpu_torch`): suppression parsing and scoping, the unused-
suppression and vacuity guards, legacy alias tags, each rule's self-
check, and the fixtures of the rules that carry over. The cases that
spell a device rule's hazard in JAX (`jnp.int64`, `jax.device_get`,
`jax.jit`, `donate_argnums`) are dropped, each with its reason: the
port's device rules match torch, so those sources either fire nothing
or pass without testing anything. In their place stand torch fixtures,
one that fires and one that is clean for each device rule
(hot-path-sync, device-sync, dtype-discipline, device-cache,
inplace-safety, cache-key, retrace-hazard), and torch versions of the
dropped suppression cases.
"""

import pytest

from tests.test_torch_server import replay
from tidb_tpu_torch.lint.engine import Forest, run

_JAX_SPELLED = ("spells the hazard in JAX ({}); the port's {} rule "
                "matches torch, see the torch fixtures below")

replay("test_lint_framework.py", globals(), drop={
    "test_multi_rule_tag": _JAX_SPELLED.format(
        "jnp.int64", "dtype-discipline"),
    "test_stacked_tags_above_one_site_all_apply": _JAX_SPELLED.format(
        "jnp.int64", "dtype-discipline"),
    "test_device_sync_negative_finalize_is_sanctioned":
        _JAX_SPELLED.format("jax.device_get", "device-sync"),
    "test_device_sync_positive_item_and_asarray": _JAX_SPELLED.format(
        "jnp.max(x).item(), jax.device_get", "device-sync"),
    "test_dtype_discipline_negative": _JAX_SPELLED.format(
        "jnp.int32", "dtype-discipline"),
    "test_dtype_discipline_only_scans_ops": _JAX_SPELLED.format(
        "jnp.int64", "dtype-discipline"),
    "test_donated_then_read_is_flagged":
        "donation-safety: torch has no buffer donation; inplace-safety "
        "is its counterpart",
    "test_return_dispatch_with_nondonating_twin_is_sanctioned":
        "donation-safety: the _jit/_jitd twins collapsed in the port",
    "test_donating_retry_loop_is_flagged":
        "donation-safety: torch has no buffer donation",
    "test_nondonating_retry_reuse_is_sanctioned":
        "donation-safety: torch has no buffer donation (the retry-memo "
        "half is test_plane_program_memo_keyed_by_cap_is_clean)",
    "test_donating_transfer_with_default_memo_is_flagged":
        "donation-safety: torch has no buffer donation (the memo hazard "
        "it guarded is inplace-safety's)",
    "test_bucketed_jit_dict_is_sanctioned": _JAX_SPELLED.format(
        "jax.jit in a bucket dict", "retrace-hazard"),
    "test_raw_shape_dispatch_is_flagged": _JAX_SPELLED.format(
        "a module-level jax.jit", "retrace-hazard"),
    "test_traced_bool_coercion_is_flagged": _JAX_SPELLED.format(
        "bool() under jax.jit", "retrace-hazard"),
    "test_device_rule_tags_suppress_and_stale_tags_report":
        _JAX_SPELLED.format("a jax.jit body", "retrace-hazard"),
})


def _lint(sources, rules):
    return run(rules=rules, forest=Forest.from_sources(sources),
               with_selfcheck=False, with_vacuity=False)


def _rules(rep):
    return [f.rule for f in rep.findings]


# -- suppression, with torch spellings --------------------------------------

def test_multi_rule_tag_torch():
    src = ("import numpy as np\nimport torch\n"
           "# lint: exempt[memtrack-alloc,dtype-discipline] staging "
           "buffer billed at dispatch; exact int64 lanes\n"
           "def f(n):\n"
           "    return np.empty(n), torch.zeros(n, dtype=torch.int64)\n")
    assert _lint({OPS_REL: src},
                 ["memtrack-alloc", "dtype-discipline"]).findings == []


def test_stacked_tags_above_one_site_all_apply_torch():
    src = ("import numpy as np\nimport torch\n"
           "def f(n):\n"
           "    # lint: exempt[memtrack-alloc] staging billed at dispatch\n"
           "    # lint: exempt[dtype-discipline] exact int64 lanes\n"
           "    return np.empty(n), torch.zeros(n, dtype=torch.int64)\n")
    assert _lint({OPS_REL: src},
                 ["memtrack-alloc", "dtype-discipline"]).findings == []


def test_device_rule_tags_suppress_and_stale_tags_report_torch():
    body = ("import torch\n"
            "from tidb_tpu_torch.ops import runtime\n"
            "class K:\n"
            "    def _kernel(self, cols, n):\n"
            "{tag}"
            "        return bool(torch.sum(cols) > 0)\n"
            "_KERNELS = runtime.FingerprintCache(8)\n"
            "def kernel_for(key):\n"
            "    def make():\n"
            "        return K()\n"
            "    return _KERNELS.get_or_create(key, make)\n")
    tag = "        # lint: exempt[retrace-hazard] host flag by design\n"
    assert _lint({OPS_REL: body.format(tag=tag)},
                 ["retrace-hazard"]).findings == []
    assert _rules(_lint({OPS_REL: body.format(tag="")},
                        ["retrace-hazard"])) == ["retrace-hazard"]
    stale = body.replace("return bool(torch.sum(cols) > 0)",
                         "return cols").format(tag=tag)
    assert _rules(_lint({OPS_REL: stale}, ["retrace-hazard"])) == \
        ["unused-suppression"]


# -- one case that fires and one that is clean, per device rule -------------

SYNC_FIRES = ("import torch\n"
              "def step(out):\n"
              "    torch.cuda.synchronize()\n"
              "    return out\n")
SYNC_CLEAN = ("import torch\n"
              "def step(out):\n"
              "    return out.sum()\n")

DEVSYNC_FIRES = ("import numpy as np\nimport torch\n"
                 "def step(x):\n"
                 "    t = torch.as_tensor(x)\n"
                 "    a = torch.max(t).item()\n"
                 "    b = t.cpu()\n"
                 "    c = np.asarray(t + 1)\n"
                 "    d = t.to('cpu')\n"
                 "    return a, b, c, d\n")
# numpy receivers, Python scalars, and a finalize boundary: all clean
DEVSYNC_CLEAN = ("import numpy as np\nimport torch\n"
                 "def host(v, d):\n"
                 "    a = np.asarray(v).tolist()\n"
                 "    b = d[0].item() if hasattr(d[0], 'item') else d[0]\n"
                 "    return a, b, int(len(a))\n"
                 "class K:\n"
                 "    def finalize(self, pending):\n"
                 "        t = torch.stack(pending)\n"
                 "        return t.cpu().numpy()\n")

DTYPE_FIRES = ("import torch\n"
               "def slots(n, x):\n"
               "    a = torch.zeros(n, dtype=torch.int64)\n"
               "    b = x.to(torch.float64)\n"
               "    c = x.long()\n"
               "    return a, b, c\n")
DTYPE_CLEAN = ("import numpy as np\nimport torch\n"
               "def slots(n, x):\n"
               "    a = torch.zeros(n, dtype=torch.int32)\n"
               "    b = np.empty(n, dtype=np.int64)   # host lanes: fine\n"
               "    return a, b, x.to(torch.float32)\n")

DEVCACHE_FIRES = ("import torch\n"
                  "from tidb_tpu_torch.ops import runtime\n"
                  "def serve(chunk, data, device):\n"
                  "    a = torch.from_numpy(data).to(device)\n"
                  "    b = torch.as_tensor(data, device=device)\n"
                  "    c = torch.from_numpy(data).cuda()\n"
                  "    d = runtime.device_put_chunk(chunk, device)\n"
                  "    return a, b, c, d\n")
DEVCACHE_CLEAN = ("import torch\n"
                  "def serve(data):\n"
                  "    t = torch.from_numpy(data)\n"
                  "    return t.to(torch.int32)\n")

INPLACE_FIRES = ("from tidb_tpu_torch.ops import runtime\n"
                 "def patch(chunk, key, idx, vals):\n"
                 "    cols = runtime.dev_cache_get(chunk, key)\n"
                 "    data, valid = cols[0]\n"
                 "    data.index_copy_(0, idx, vals)\n"
                 "    valid[idx] = True\n"
                 "    flat = data.view(-1)\n"
                 "    flat += 1\n")
# the store/device_cache.scatter_block shape: clone, then write
INPLACE_CLEAN = ("from tidb_tpu_torch.ops import runtime\n"
                 "def patch(chunk, key, idx, vals):\n"
                 "    cols = runtime.dev_cache_get(chunk, key)\n"
                 "    data, valid = cols[0]\n"
                 "    nd, nv = data.clone(), valid.clone()\n"
                 "    nd.index_copy_(0, idx, vals)\n"
                 "    nv[idx] = True\n"
                 "    return nd, nv\n")

CACHE_KEY_BODY = ("from tidb_tpu_torch.ops import runtime\n"
                  "from tidb_tpu_torch import devplane\n"
                  "class K:\n"
                  "    def __init__(self, exprs, width, device):\n"
                  "        self.exprs = exprs\n"
                  "        self.width = width\n"
                  "        self.device = device\n"
                  "    def _kernel(self, cols, n):\n"
                  "        return (cols, self.width)\n"
                  "_KERNELS = runtime.FingerprintCache(8)\n"
                  "def kernel_for(exprs, width, device):\n"
                  "    fp = runtime.plan_fingerprint(None, exprs, [])\n"
                  "    key = {key}\n"
                  "    def make():\n"
                  "        return K(exprs, width, device)\n"
                  "    return _KERNELS.get_or_create(key, make)\n")
CACHE_KEY_FIRES = CACHE_KEY_BODY.format(key="(fp, width)")
CACHE_KEY_CLEAN = CACHE_KEY_BODY.format(
    key="(fp, width, str(device), devplane.mesh_fingerprint(process=True))")

RETRACE_FIRES = ("import torch\n"
                 "from tidb_tpu_torch import devplane\n"
                 "def sort_body(data):\n"
                 "    top = torch.max(data)\n"
                 "    return torch.sort(data)[0], float(top), top.tolist()\n"
                 "_sort = devplane.plane_jit(sort_body)\n"
                 "def device_sort(data):\n"
                 "    return _sort(data)\n")
RETRACE_CLEAN = ("import torch\n"
                 "from tidb_tpu_torch import devplane\n"
                 "from tidb_tpu_torch.ops import runtime\n"
                 "def sort_body(data, m):\n"
                 "    bits = max(1, int(m - 1).bit_length())\n"
                 "    return torch.sort(data)[0] >> bits\n"
                 "_sort = devplane.plane_jit(sort_body)\n"
                 "def device_sort(chunk):\n"
                 "    size = runtime.bucket_size(chunk.num_rows)\n"
                 "    cols, _d = runtime.device_put_chunk(chunk, size=size)\n"
                 "    return _sort(cols[0][0], size)\n")

DEVICE_CASES = {
    "hot-path-sync": (OPS_REL, SYNC_FIRES, SYNC_CLEAN, 1),
    "device-sync": (OPS_REL, DEVSYNC_FIRES, DEVSYNC_CLEAN, 4),
    "dtype-discipline": (OPS_REL, DTYPE_FIRES, DTYPE_CLEAN, 3),
    "device-cache": (STORE_REL, DEVCACHE_FIRES, DEVCACHE_CLEAN, 4),
    "inplace-safety": (OPS_REL, INPLACE_FIRES, INPLACE_CLEAN, 3),
    "cache-key": (OPS_REL, CACHE_KEY_FIRES, CACHE_KEY_CLEAN, 2),
    "retrace-hazard": (OPS_REL, RETRACE_FIRES, RETRACE_CLEAN, 3),
}


@pytest.mark.parametrize("rule", sorted(DEVICE_CASES))
def test_device_rule_fires_on_its_torch_hazard(rule):
    rel, fires, _clean, n = DEVICE_CASES[rule]
    rep = _lint({rel: fires}, [rule])
    assert _rules(rep) == [rule] * n, rep.findings


@pytest.mark.parametrize("rule", sorted(DEVICE_CASES))
def test_device_rule_is_clean_on_the_sanctioned_shape(rule):
    rel, _fires, clean, _n = DEVICE_CASES[rule]
    assert _lint({rel: clean}, [rule]).findings == []


def test_dtype_discipline_only_scans_ops_torch():
    assert _lint({STORE_REL: DTYPE_FIRES},
                 ["dtype-discipline"]).findings == []


def test_device_cache_sanctions_the_audited_helper():
    assert _lint({"tidb_tpu_torch/store/device_cache.py": DEVCACHE_FIRES},
                 ["device-cache"]).findings == []


def test_hot_path_sync_sanctions_the_timing_helpers():
    assert _lint({"tidb_tpu_torch/runtime_stats.py": SYNC_FIRES},
                 ["hot-path-sync"]).findings == []


def test_inplace_follows_resident_tensors_across_calls():
    """A helper fed a resident block's lanes by its caller is held to
    the rule: the scatter_block shape without its clone() fires."""
    src = ("def scatter(cols, idx, vals):\n"
           "    out = []\n"
           "    for data, valid in cols:\n"
           "        data.index_copy_(0, idx, vals)\n"
           "        out.append((data, valid))\n"
           "    return out\n"
           "def patch(block, idx, vals):\n"
           "    return scatter(block.cols, idx, vals)\n")
    rep = _lint({STORE_REL: src}, ["inplace-safety"])
    assert [(f.rule, f.line) for f in rep.findings] == \
        [("inplace-safety", 4)]
    # the analysis is flow-insensitive: the clone binds a fresh name, as
    # scatter_block's `nd, nv = data.clone(), valid.clone()` does
    fixed = src.replace("        data.index_copy_(0, idx, vals)\n"
                        "        out.append((data, valid))\n",
                        "        nd = data.clone()\n"
                        "        nd.index_copy_(0, idx, vals)\n"
                        "        out.append((nd, valid))\n")
    assert _lint({STORE_REL: fixed}, ["inplace-safety"]).findings == []


def test_cache_key_requires_the_device_in_a_device_kernels_key():
    src = CACHE_KEY_BODY.format(
        key="(fp, width, devplane.mesh_fingerprint(process=True))")
    msgs = [f.message for f in _lint({OPS_REL: src},
                                     ["cache-key"]).findings]
    assert len(msgs) == 1 and "str(device)" in msgs[0]


def test_cache_key_build_must_cover_its_flags():
    """The segsum build's shape: a reuse check that reads the source
    alone keeps loading a library built with other flags."""
    src = ("import subprocess\n"
           "SOURCE = 'k.cu'\n"
           "FLAGS = ['-O3']\n"
           "LIBRARY = 'k.so'\n"
           "def build_key():\n"
           "    return hash((open(SOURCE).read(), tuple(FLAGS)))\n"
           "def command(out):\n"
           "    return ['nvcc', *FLAGS, '-o', out, SOURCE]\n"
           "def build(stamp):\n"
           "    if {test}:\n"
           "        return LIBRARY\n"
           "    subprocess.run(command(LIBRARY))\n"
           "    return LIBRARY\n")
    stale = _lint({OPS_REL: src.format(test="stamp(SOURCE, LIBRARY)")},
                  ["cache-key"]).findings
    assert len(stale) == 1 and "FLAGS" in stale[0].message
    keyed = src.format(test="stamp(LIBRARY) == build_key()")
    assert _lint({OPS_REL: keyed}, ["cache-key"]).findings == []


def test_plane_program_memo_keyed_by_cap_is_clean():
    """The bounded bucket-dict program memo (the reference's
    meshjoin._stage2_jits[bucket] shape) through plane_jit: the memo key
    is bucketed, the dispatch's operands are shaped."""
    src = ("from tidb_tpu_torch import devplane\n"
           "from tidb_tpu_torch.ops import runtime\n"
           "class K:\n"
           "    def __init__(self):\n"
           "        self._progs = {}\n"
           "    def _program(self, cols, n):\n"
           "        return cols\n"
           "    def _get(self, bucket):\n"
           "        p = self._progs.get(bucket)\n"
           "        if p is None:\n"
           "            p = self._progs[bucket] = "
           "devplane.plane_jit(self._program)\n"
           "        return p\n"
           "    def launch(self, probe):\n"
           "        cols, _d = runtime.device_put_chunk(probe)\n"
           "        bkt = runtime.bucket_size(probe.num_rows)\n"
           "        return self._get(bkt)(cols, probe.num_rows)\n")
    assert _lint({OPS_REL: src}, ["retrace-hazard"]).findings == []
    raw = src.replace("bkt = runtime.bucket_size(probe.num_rows)",
                      "bkt = probe.num_rows")
    msgs = [f.message for f in _lint({OPS_REL: raw},
                                     ["retrace-hazard"]).findings]
    assert any("not bucketed" in m for m in msgs)


def test_plane_kernel_built_outside_a_kernel_cache_is_flagged():
    """A class owning plane_jit programs, constructed per statement,
    rebuilds (and re-registers) them every time; built under a dict memo
    keyed on the plane it is cached."""
    cls = ("from tidb_tpu_torch import devplane\n"
           "class K:\n"
           "    def __init__(self, mesh, n):\n"
           "        self.mesh = mesh\n"
           "        self.n = n\n"
           "        self._prog = devplane.plane_jit(self._program)\n"
           "    def _program(self, cols):\n"
           "        return cols\n")
    per_stmt = cls + ("def run(mesh, n, cols):\n"
                      "    return K(mesh, n)._prog(cols)\n")
    msgs = [f.message for f in _lint({OPS_REL: per_stmt},
                                     ["cache-key"]).findings]
    assert any("outside a kernel cache" in m for m in msgs), msgs
    cached = cls + ("_KS = {}\n"
                    "def kernel(mesh, n):\n"
                    "    key = (devplane.mesh_fingerprint(process=True), n)\n"
                    "    k = _KS.get(key)\n"
                    "    if k is None:\n"
                    "        k = _KS[key] = K(mesh, n)\n"
                    "    return k\n")
    assert _lint({OPS_REL: cached}, ["cache-key"]).findings == []
