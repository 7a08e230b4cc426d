"""Test configuration.

The suite runs on a virtual 8-device CPU platform (so multi-device
sharding tests run anywhere) unless JAX_PLATFORMS says otherwise: the
tests marked ``gpu`` run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``. This must happen
before jax is imported by any test module.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def gpu():
    """The first JAX device, when it is a GPU; skips otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX devices are {dev.platform})")
    return dev


@pytest.fixture(scope="session")
def ref_driver(tmp_path_factory):
    """Build a small driver around the reference C library for
    cross-validation. Skips if the reference tree or gcc is unavailable."""
    src = REF / "c" / "src" / "liblzs"
    if not src.exists():
        pytest.skip("reference tree not available")
    build = tmp_path_factory.mktemp("refbin")
    drv = build / "drv.c"
    drv.write_text(r'''
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "lzs.h"
static unsigned char* readall(const char* p, size_t* n){
    FILE* f=fopen(p,"rb"); if(!f) return 0;
    fseek(f,0,SEEK_END); *n=ftell(f); fseek(f,0,SEEK_SET);
    unsigned char* b=malloc(*n+16); fread(b,1,*n,f); fclose(f); return b; }
int main(int argc, char** argv){
    size_t n; unsigned char* in = readall(argv[2], &n);
    size_t cap = n*20 + 4096;
    unsigned char* out = malloc(cap);
    size_t m = 0;
    if (!strcmp(argv[1],"c")) m = lzs_compress(out, cap, in, n);
    else if (!strcmp(argv[1],"d")) m = lzs_decompress(out, cap, in, n);
    else if (!strcmp(argv[1],"s")) m = lzs_simple_compress(out, cap, in, n);
    else return 2;
    FILE* f=fopen(argv[3],"wb"); fwrite(out,1,m,f); fclose(f);
    return 0;
}
''')
    exe = build / "drv"
    cc = subprocess.run(
        ["gcc", "-O2", f"-I{src}", "-o", str(exe), str(drv),
         str(src / "lzs-compression.c"),
         str(src / "lzs-compression-simple.c"),
         str(src / "lzs-decompression.c")],
        capture_output=True, text=True)
    if cc.returncode != 0:
        pytest.skip(f"cannot build reference driver: {cc.stderr}")

    def run(mode: str, data: bytes) -> bytes:
        inp = build / "in.bin"
        outp = build / "out.bin"
        inp.write_bytes(data)
        subprocess.run([str(exe), mode, str(inp), str(outp)], check=True)
        return outp.read_bytes()

    return run
