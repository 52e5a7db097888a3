# Convenience entry points. The test suite itself is plain pytest.

.PHONY: test native goldens

test:
	python -m pytest tests/ -q

native:
	$(MAKE) -C native

goldens:
	JAX_PLATFORMS=cpu python -m whisper_git_tpu.tools.goldens
