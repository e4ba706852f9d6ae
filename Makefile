# Convenience targets (the package itself is pure Python + JAX).

PYTHON ?= python

.PHONY: test bench baseline capi cpp cc_example clean

test:
	$(PYTHON) -m pytest tests/ -q

.PHONY: test-fast
test-fast:  ## the <5 min lane: skips the multi-minute end-to-end runs
	$(PYTHON) -m pytest tests/ -q -m "not slow"


bench:
	$(PYTHON) bench.py

# C ABI shared library (reference interfaces.h analogue; embeds CPython)
capi: lib/libpolychordlite_tpu.so

lib/libpolychordlite_tpu.so: csrc/capi.c csrc/capi.h
	mkdir -p lib
	gcc -O2 -shared -fPIC $(shell python3-config --includes) -o $@ csrc/capi.c 		$(shell python3-config --embed --ldflags)

# typed C++ API over the C ABI (reference interfaces.hpp analogue)
cpp: lib/libpolychordlite_tpu_cpp.so

lib/libpolychordlite_tpu_cpp.so: csrc/polychord_cpp.cpp csrc/polychord.hpp csrc/capi.c csrc/capi.h
	mkdir -p lib
	gcc -O2 -c -fPIC $(shell python3-config --includes) -o lib/capi.o csrc/capi.c
	g++ -O2 -shared -fPIC -Icsrc $(shell python3-config --includes) -o $@ \
		csrc/polychord_cpp.cpp lib/capi.o \
		$(shell python3-config --embed --ldflags)

# shipped C++ example driver (reference src/drivers/polychord_CC.cpp analogue)
# runs on the CPU backend: a C callback likelihood is host code, so its slice
# epochs run on the host CPU device — the reference's slow-likelihood regime,
# where the sampler overhead is negligible.
cc_example: cpp
	mkdir -p bin chains/clusters
	g++ -O2 -Icsrc -o bin/gaussian_cc examples/cc/gaussian_cc.cpp \
		-Llib -lpolychordlite_tpu_cpp -Wl,-rpath,'$$ORIGIN/../lib' \
		$(shell python3-config --embed --ldflags)
	PYTHONPATH="$(CURDIR):$(shell $(PYTHON) -c 'import sys; print(":".join(p for p in sys.path if p.endswith("site-packages")))')" \
		JAX_PLATFORMS=cpu ./bin/gaussian_cc

# native single-core baseline used by bench.py
baseline: build/slice_baseline_bench

build/slice_baseline_bench: csrc/slice_baseline.c
	mkdir -p build
	gcc -O3 -march=native -o $@ $< -lm

# on-card smoke test of the main path (needs an NVIDIA GPU)
.PHONY: chip-smoke
chip-smoke:
	$(PYTHON) chip_smoke.py

clean:
	rm -rf build polychordlite_tpu/**/__pycache__
