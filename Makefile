CXX ?= g++
CXXFLAGS ?= -O3 -march=native -fPIC -shared -fopenmp -std=c++17

.PHONY: all test quick examples gpu-test

all: orphics_tpu/csrc/liborphics_healpix.so

orphics_tpu/csrc/liborphics_healpix.so: orphics_tpu/csrc/healpix.cpp
	$(CXX) $(CXXFLAGS) -o $@ $<

test:
	python -m pytest tests/ -q

quick:
	python -m pytest tests/ -m quick -q

examples:
	python -m pytest tests/test_examples_smoke.py -q

gpu-test:
	JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -q

clean:
	rm -f orphics_tpu/csrc/*.so
