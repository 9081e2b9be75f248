# Convenience targets. Bench targets run on the default JAX platform (a
# GPU); test targets force the hermetic CPU backend via tests/conftest.py.

.PHONY: test test-fast smoke bench bench-stream bench-micro middlebury dryrun lint

test:
	python -m pytest tests/ -q

test-fast:
	python -m pytest tests/ -q -m "not slow"

smoke:
	python chip_smoke.py

bench:
	python bench.py

bench-stream:
	python -m gpu_stereo_matching_tpu.bench.streaming

bench-micro:
	python -m gpu_stereo_matching_tpu.bench.micro

bench-st-stream:
	python -m gpu_stereo_matching_tpu.bench.st_streaming

middlebury:
	python -m gpu_stereo_matching_tpu.cli.main middlebury --pipelines bm,bm+,st1,st2

dryrun:
	XLA_FLAGS="--xla_force_host_platform_device_count=8" \
	python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
