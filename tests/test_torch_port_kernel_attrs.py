"""No CUDA source of the port keeps a kernel attribute or an SM count in a
``static``, and no kernel wrapper keeps an SM count in a module constant.

A function attribute (``cudaFuncSetAttribute``: the dynamic shared memory
a kernel may take) belongs to the current device's context, and so does
the SM count a persistent grid is sized by.  A function-local ``static``
fills once per process, on the first device that launches, so the first
launch on a second card would run without the attribute, or with the
first card's grid.  Every launch sets the attribute and asks for the
count instead (``csrc/hopper.cuh`` ``allow_smem``, ``sm_count``).  A box
with one card cannot launch on a second, so this reads the sources: the
check ``static_holders`` makes is held to the forms it must find and the
ones it must pass, then run on every ``bigdl_torch/csrc`` file.  The same
holds of the host side: a wrapper that sizes its launch by the SM count
asks the launching device (``ops/decode_attention.py`` ``sm_count``), so
``sm_constants`` finds a module-level integer named for SMs in every
``bigdl_torch/ops`` module.
"""

import ast
import glob
import os
import re

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_REPO, "bigdl_torch", "csrc")
_OPS = os.path.join(_REPO, "bigdl_torch", "ops")

#: a call whose result is per device
_PER_DEVICE = re.compile(r"cudaFuncSetAttribute|allow_smem|sm_count|"
                         r"[Mm]ultiProcessorCount")
_OPEN, _CLOSE = "({[", ")}]"


def _strip(src):
    """Comments and string literals blanked out."""
    return re.sub(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\])*"',
                  lambda m: " " * len(m.group(0)), src, flags=re.S)


def _statement_end(src, i):
    """Index of the ';' that ends the statement running from ``i``, outside
    every bracket (a lambda's body included)."""
    depth = 0
    for j in range(i, len(src)):
        c = src[j]
        if c in _OPEN:
            depth += 1
        elif c in _CLOSE:
            depth -= 1
        elif c == ";" and depth == 0:
            return j
    return len(src)


def _matching(src, i):
    """Index of the bracket that closes the one at ``i``."""
    depth = 0
    for j in range(i, len(src)):
        if src[j] in _OPEN:
            depth += 1
        elif src[j] in _CLOSE:
            depth -= 1
            if depth == 0:
                return j
    return len(src)


def static_holders(src):
    """Names of the ``static`` variables in C++ ``src`` whose initializer,
    or a later assignment to them, calls something per device."""
    src = _strip(src)
    bad, names = [], []
    for m in re.finditer(r"\bstatic\b(?!_)", src):
        head = re.match(r"[^=;{(]*", src[m.end():]).group(0)
        if re.search(r"\bconstexpr\b", head):
            continue                # a compile-time constant
        k = m.end() + len(head)
        if k >= len(src):
            break
        ident = re.findall(r"(\w+)\s*(?:\[[^\]]*\])?\s*$", head)
        if src[k] == "(":
            close = _matching(src, k)
            after = src[close + 1:].lstrip()
            if not after.startswith(";"):
                continue            # a function, not a variable
            init = src[k:close + 1]
        elif src[k] == ";":
            init = ""
        else:
            init = src[k:_statement_end(src, k)]
        if not ident:
            continue
        name = ident[-1]
        names.append((name, _statement_end(src, k)))
        if _PER_DEVICE.search(init):
            bad.append(name)
    for name, after in names:
        for a in re.finditer(rf"\b{name}\s*(?:\[[^\]]*\])?\s*=(?!=)",
                             src[after:]):
            rhs = src[after + a.end():_statement_end(src, after + a.end())]
            if _PER_DEVICE.search(rhs) and name not in bad:
                bad.append(name)
    return bad


FLAGGED = {
    "attribute": ("static const cudaError_t attr = cudaFuncSetAttribute(\n"
                  "    k, cudaFuncAttributeMaxDynamicSharedMemorySize, n);"),
    "attribute_array": (
        "static const cudaError_t attr[2] = {\n"
        "    cudaFuncSetAttribute(a, cudaFuncAttributeMaxDynamicSharedMemory"
        "Size, n),\n    cudaFuncSetAttribute(b, x, n)};"),
    "sm_count": "static const int n_sm = hopper::sm_count();",
    "assigned_later": ("static int n_sm = 0;\n"
                       "if (n_sm == 0) n_sm = hopper::sm_count();"),
    "lambda": ("static const cudaError_t e = [] {\n"
               "  return hopper::allow_smem(k, 1 << 17);\n}();"),
    "direct_init": "static const int n(hopper::sm_count());",
    "properties": "static int sms{prop.multiProcessorCount};",
    "device_attribute": ("static int n;\ncudaDeviceGetAttribute(&n, "
                         "cudaDevAttrMultiProcessorCount, 0);\n"
                         "n = sms_of(cudaDevAttrMultiProcessorCount);"),
}

PASSED = {
    "per_launch": ("const int n_sm = hopper::sm_count();\n"
                   "const cudaError_t a = hopper::allow_smem(k, n);"),
    "constexpr": "static constexpr int SMEM = 4 * 1024;",
    "function": ("__device__ static __forceinline__ int f(int x) {\n"
                 "  return x + sm_count();\n}"),
    "entry_point": ("static const EncodeTiledFn fn = [] {\n"
                    "  void* p = nullptr;\n  cudaGetDriverEntryPoint(\"x\", "
                    "&p, cudaEnableDefault, &q);\n  return p;\n}();"),
    "comment": "// static const int n_sm = hopper::sm_count();\nint x = 1;",
    "cast": "const int g = static_cast<int>(hopper::sm_count());",
}


@pytest.mark.parametrize("form", sorted(FLAGGED))
def test_check_finds_a_static_per_device_value(form):
    assert static_holders(FLAGGED[form]), FLAGGED[form]


@pytest.mark.parametrize("form", sorted(PASSED))
def test_check_passes_per_launch_and_constant_forms(form):
    assert static_holders(PASSED[form]) == [], PASSED[form]


def _sources():
    """Every CUDA source and header, and every host C++ source and header
    (``csrc/host``)."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) +
                  glob.glob(os.path.join(_CSRC, "*.cuh")) +
                  glob.glob(os.path.join(_CSRC, "host", "*.cc")) +
                  glob.glob(os.path.join(_CSRC, "host", "*.h")))


def test_every_source_is_read():
    names = {os.path.basename(p) for p in _sources()}
    assert {"flash_attention.cu", "flash_attention_bwd.cu",
            "matmul_stats.cu", "batchnorm.cu", "decode_attention.cu",
            "hopper.cuh", "crc32c.cc", "crc32c.h", "recordio.cc",
            "prefetch.cc", "hostops.cc"} <= names


@pytest.mark.parametrize("path", _sources(), ids=os.path.basename)
def test_no_static_kernel_attribute_or_sm_count(path):
    with open(path) as f:
        bad = static_holders(f.read())
    assert bad == [], (f"{os.path.basename(path)} keeps {bad} in a static: "
                       "set the attribute and ask for the SM count on every "
                       "launch (csrc/hopper.cuh allow_smem, sm_count)")


#: a name that speaks of streaming multiprocessors
_SM_NAME = re.compile(r"(?:^|_)SMS(?:$|_)|SM_?COUNT|MULTI_?PROCESSOR",
                      re.I)


def sm_constants(src):
    """Names bound at module level in Python ``src`` to an integer literal
    (or an expression of literals) whose name speaks of SMs."""
    bad = []
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        literal = all(isinstance(n, (ast.Constant, ast.BinOp, ast.UnaryOp,
                                     ast.operator, ast.unaryop,
                                     ast.expr_context))
                      for n in ast.walk(value))
        consts = [n.value for n in ast.walk(value)
                  if isinstance(n, ast.Constant)]
        if not literal or not consts or \
                not all(isinstance(c, int) for c in consts):
            continue
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name) and _SM_NAME.search(n.id):
                    bad.append(n.id)
    return bad


SM_FLAGGED = {
    "sms": "SMS = 132",
    "annotated": "NUM_SMS: int = 132",
    "card_named": "H100_SMS = 132",
    "count": "sm_count = 114",
    "expression": "SM_COUNT = 2 * 66",
    "properties": "MULTIPROCESSORS = 132",
}

SM_PASSED = {
    "per_device_cache": "_sm_counts = {}",
    "other_constant": "MAX_SPLITS = 8\nMIN_ROWS = 32",
    "per_sm_ratio": "_VEC_BLOCKS_PER_SM = 2",
    "asked": "SMS = torch.cuda.get_device_properties(0)"
             ".multi_processor_count",
    "local": "def splits(S, sms):\n    SMS = 132\n    return S * SMS",
    "argument": "def splits(S, H, L, sms):\n    return S * H < sms",
}


@pytest.mark.parametrize("form", sorted(SM_FLAGGED))
def test_check_finds_a_module_sm_constant(form):
    assert sm_constants(SM_FLAGGED[form]), SM_FLAGGED[form]


@pytest.mark.parametrize("form", sorted(SM_PASSED))
def test_check_passes_asked_and_other_forms(form):
    assert sm_constants(SM_PASSED[form]) == [], SM_PASSED[form]


def _ops_modules():
    return sorted(glob.glob(os.path.join(_OPS, "*.py")))


@pytest.mark.parametrize("path", _ops_modules(), ids=os.path.basename)
def test_no_module_sm_constant_in_ops(path):
    with open(path) as f:
        bad = sm_constants(f.read())
    assert bad == [], (f"{os.path.basename(path)} keeps {bad} at module "
                       "level: ask the launching device for its SM count "
                       "(ops/decode_attention.py sm_count)")
