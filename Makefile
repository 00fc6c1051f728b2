# Developer entry points, mirroring the reference's Makefile surface
# (make run / make test, reference Makefile:8-12) plus the native build.

maxThreads = 4

.PHONY: all native test run clean

all: native

native:
	g++ -O3 -march=native -shared -fPIC -std=c++17 \
	    nanopore_tpu/runtime/native/seedchain.cpp \
	    -o nanopore_tpu/runtime/native/libseedchain.so

test:
	python -m pytest tests/ -x -q

# run the pipeline on a working directory: make run workingDir=path/to/dir
workingDir = tests_workdir
run:
	python -m nanopore_tpu.cli run $(workingDir) --max-threads $(maxThreads)

bench:
	python bench.py

clean:
	rm -f nanopore_tpu/runtime/native/libseedchain.so
	rm -rf nanopore_tpu_torch/_build
	find . -name __pycache__ -type d | xargs rm -rf
