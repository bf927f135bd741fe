# One-command verify recipes (see ROADMAP.md "Tier-1 verify").
PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))
export PYTHONPATH

.PHONY: test test-all test-fast check check-torch falsify-smoke bench-smoke bench-delay bench-drift bench-renew bench-json bench-compare bench dev-deps

test:  ## fast default: skip the long @slow differential replays
	python -m pytest -x -q -m "not slow"

test-all:  ## tier-1: the full suite (including @slow), fail-fast
	python -m pytest -x -q

test-fast:  ## also skip the slow XLA-compile cross-validation tests
	python -m pytest -x -q -m "not slow" --ignore=tests/test_roofline_validation.py

check:  ## leaselint: static pack-budget proof, kernel purity, launch audit, convention lints + mutation self-test (docs/static_analysis.md)
	python -m repro.analysis.staticcheck --json findings.json
	@if command -v ruff >/dev/null 2>&1; then \
	  ruff check src tests benchmarks examples; \
	else \
	  echo "ruff not installed; skipping the crash-level baseline (CI runs it)"; \
	fi

check-torch:  ## leaselint for the PyTorch/CUDA port: launch plans of the CUDA lease kernels, int32 purity, conventions + mutation self-test (CPU, no card)
	python -m repro_torch.analysis.staticcheck

falsify-smoke:  ## seeded fixed-budget falsification contract (docs/falsification.md): the corrupt negative control MUST violate, the honest search must NOT — each also run with the crash/restart planes enabled (honest faults: the corrupt pair still violates, the honest pair still must not)
	python -m repro.lease_array.falsify --mode corrupt --seed 7 --pop 128 --generations 6 --expect violation --out falsify_corrupt.json
	python -m repro.lease_array.falsify --mode honest --seed 7 --pop 128 --generations 6 --expect none --out falsify_honest.json
	python -m repro.lease_array.falsify --mode corrupt --restarts --seed 7 --pop 128 --generations 6 --expect violation --out falsify_corrupt_restart.json
	python -m repro.lease_array.falsify --mode honest --restarts --seed 7 --pop 128 --generations 6 --expect none --out falsify_honest_restart.json
	python -m repro.lease_array.falsify --mode corrupt --extends --seed 0 --pop 128 --generations 6 --expect violation --out falsify_corrupt_extend.json
	python -m repro.lease_array.falsify --mode honest --extends --seed 0 --pop 128 --generations 6 --expect none --out falsify_honest_extend.json

bench-smoke:  ## quick end-to-end signal: the vectorized lease-plane bench
	python -c "from benchmarks.bench_lease_array import run; \
	  [print(f'{n},{u:.2f},\"{d}\"') for n, u, d in run()]"

bench-delay:  ## netplane smoke: delay-depth sweep of the in-flight plane
	python -c "from benchmarks.bench_lease_array import run_delayed; \
	  [print(f'{n},{u:.2f},\"{d}\"') for n, u, d in run_delayed()]"

bench-drift:  ## drifted-clock smoke: the eps=0.25 netplane scan row
	python -c "from benchmarks.bench_lease_array import run_drift; \
	  [print(f'{n},{u:.2f},\"{d}\"') for n, u, d in run_drift()]"

bench-renew:  ## §6 renewal storm (quiescence-skip A/B, owned_frac >= 0.95 at delay<=4) + deposed-owner failover handoff
	python -c "from benchmarks.bench_lease_array import run_renew; \
	  [print(f'{n},{u:.2f},\"{d}\"') for n, u, d in run_renew()]"

bench-json:  ## all lease-plane modes -> machine-readable BENCH_lease_array.json
	python -m benchmarks.bench_lease_array

bench-compare:  ## fresh bench run diffed against the committed baseline (>25% regression fails; measured on row ratios when the machines differ)
	python -m benchmarks.bench_lease_array BENCH_candidate.json
	python -m benchmarks.compare_bench BENCH_lease_array.json BENCH_candidate.json > BENCH_compare.txt; \
	  status=$$?; cat BENCH_compare.txt; exit $$status

bench:  ## every paper table (slow)
	python -m benchmarks.run

dev-deps:
	pip install -r requirements-dev.txt
