#!/usr/bin/env bash
# Sanitizer build + test of the port's native layer (the port's own
# copies of convertor.cpp, fastdss.c, arena.c and net.c under
# ompi_tpu_torch/_native/); the counterpart of the repo's
# tools/asan_native.sh.
#
# Compiles the four sources with -fsanitize=address,undefined to the
# hash-named paths the port's lazy loader expects (read from
# ompi_tpu_torch._native, the fastdss stem _fastdss_torch-<soabi>
# included), checks that each library loads from its sanitized,
# instrumented file, then runs the port's convertor/pack/dss/arena/net
# tests with the sanitizer runtimes preloaded (python itself is not
# ASAN-built, so libasan/libubsan come in via LD_PRELOAD).  Any heap
# overflow or UB in the C walks fails the run.  The sanitized .so files
# are deleted afterwards: they load only under the preload, and a
# normal process that found one in the hash cache would fall back to
# the Python paths.
#
# Run it from the root of a COPY of the tree: the sanitized libraries
# take the normal ones' paths in build/ompi_tpu_torch/native/, so a
# process of the same checkout that loads one without the preload
# (a concurrent test worker, say) silently loses its native layer.
#
# Usage: bash ompi_tpu_torch/tools/asan_native.sh [pytest args...]
#        (arguments replace the default list of test files)
set -euo pipefail

CXX=${CXX:-g++}
CC=${CC:-gcc}
SAN="-fsanitize=address,undefined -fno-sanitize-recover=all -O1 -g"

TESTS=("$@")
if [ ${#TESTS[@]} -eq 0 ]; then
    TESTS=(tests/test_torch_native.py
           tests/test_torch_mirror_native.py
           tests/test_torch_datatype.py
           tests/test_torch_datatype_ext.py
           tests/test_torch_mirror_datatype.py
           tests/test_torch_coll_shm.py
           tests/test_torch_mirror_coll.py
           tests/test_torch_core_mirror.py::test_dss_case)
fi

# hash-named destinations, straight from this checkout's loader (an
# assignment first, so that a refusal stops the script under set -e)
paths=$(python - <<'EOF'
import os, sysconfig
from ompi_tpu_torch import _native as n
root = os.path.realpath(os.getcwd())
here = os.path.realpath(n.__file__)
if not here.startswith(os.path.join(root, "")):
    raise SystemExit(f"asan_native: ompi_tpu_torch loads from {here}, not "
                     f"from this checkout ({root}); run from its root")
soabi = sysconfig.get_config_var("SOABI") or "abi-unknown"
print(f"NATIVE_DIR={n._DIR}")
print(f"BUILD_DIR={n.BUILD_DIR}")
print(f"CONV_SO={n._so_path()}")
print(f"FASTDSS_SO={n._hash_name(n._FASTDSS_SRC, f'_fastdss_torch-{soabi}')}")
print(f"ARENA_SO={n._hash_name(n._ARENA_SRC, '_arena')}")
print(f"NET_SO={n._hash_name(n._NET_SRC, '_net')}")
print(f"PYINC={sysconfig.get_paths()['include']}")
EOF
)
eval "$paths"

cleanup() { rm -f "$CONV_SO" "$FASTDSS_SO" "$ARENA_SO" "$NET_SO"; }
trap cleanup EXIT
mkdir -p "$BUILD_DIR"

echo "== sanitized build: convertor.cpp -> $CONV_SO"
$CXX $SAN -shared -fPIC -o "$CONV_SO" "$NATIVE_DIR/convertor.cpp"
echo "== sanitized build: fastdss.c -> $FASTDSS_SO"
$CC $SAN -shared -fPIC -I"$PYINC" -o "$FASTDSS_SO" "$NATIVE_DIR/fastdss.c"
echo "== sanitized build: arena.c -> $ARENA_SO"
$CC $SAN -shared -fPIC -o "$ARENA_SO" "$NATIVE_DIR/arena.c"
echo "== sanitized build: net.c -> $NET_SO"
$CC $SAN -shared -fPIC -o "$NET_SO" "$NATIVE_DIR/net.c"

# each library calls into the ASan runtime: its dynamic table imports
# __asan_* symbols
for so in "$CONV_SO" "$FASTDSS_SO" "$ARENA_SO" "$NET_SO"; do
    n_asan=$(nm -D --undefined-only "$so" | grep -c ' __asan_' || true)
    if [ "$n_asan" -eq 0 ]; then
        echo "asan_native: $so carries no ASan instrumentation" >&2
        exit 1
    fi
    echo "instrumented: $so ($n_asan __asan_ imports)"
done

LIBASAN=$($CXX -print-file-name=libasan.so)
LIBUBSAN=$($CXX -print-file-name=libubsan.so)

# leak detection off: CPython "leaks" interned objects by design, and
# the interceptors see every allocation the interpreter ever makes —
# the signal here is overflow/UB in the port's walks, not interpreter
# noise
export ASAN_OPTIONS="detect_leaks=0:abort_on_error=1"
export UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1"
export LD_PRELOAD="$LIBASAN:$LIBUBSAN"
export CONV_SO FASTDSS_SO ARENA_SO NET_SO

echo "== native layer self-check under ASan/UBSan"
python - <<'EOF'
import os

from ompi_tpu_torch import _native

def same(a, b):
    return os.path.realpath(a) == os.path.realpath(b)

lib = _native.lib()
assert lib is not None, "sanitized convertor failed to load"
assert lib.ompi_tpu_native_abi() == _native._ABI
assert same(lib._name, os.environ["CONV_SO"]), lib._name
fd = _native.fastdss()
assert fd is not None, "sanitized fastdss failed to load"
assert same(fd.__file__, os.environ["FASTDSS_SO"]), fd.__file__
ar = _native.arena()
assert ar is not None, "sanitized arena executor failed to load"
assert ar.ompi_tpu_arena_abi() == _native._ARENA_ABI
assert same(ar._name, os.environ["ARENA_SO"]), ar._name
nt = _native.net()
assert nt is not None, "sanitized net plane failed to load"
assert nt.ompi_tpu_net_abi() == _native._NET_ABI
assert same(nt._name, os.environ["NET_SO"]), nt._name
for name, path in (("convertor", lib._name), ("fastdss", fd.__file__),
                   ("arena", ar._name), ("net", nt._name)):
    print(f"loaded sanitized {name}: {path}")
print("sanitized native layer loaded, ABI", _native._ABI,
      "arena ABI", _native._ARENA_ABI, "net ABI", _native._NET_ABI)
EOF

echo "== convertor/pack/dss/arena/net tests under ASan/UBSan"
# test_torch_native drives every arena and net entry point and the
# convertor walks; the mirrored native, datatype and coll bodies run the
# reference's own cases over the sanitized executors; test_torch_coll_shm
# runs the arena's collective protocols; the dss cases run the codec
env JAX_PLATFORMS=cpu python -m pytest -q -p no:cacheprovider "${TESTS[@]}"
echo "== ASan/UBSan native run clean"
