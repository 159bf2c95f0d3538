# gatekeeper-tpu build/test entry points (the reference's Makefile roles:
# native-test, docker-build, deploy).

IMG ?= gatekeeper-tpu:latest
IMG_TORCH ?= gatekeeper-tpu-torch:latest
, := ,
NAMESPACE ?= gatekeeper-system

.PHONY: manifests
manifests:  ## regenerate charts/gatekeeper-tpu from deploy/gatekeeper.yaml
	python tools/helmify.py

.PHONY: manifests-torch
manifests-torch:  ## regenerate charts/gatekeeper-tpu-torch from deploy/gatekeeper-torch.yaml
	python tools/helmify_torch.py

.PHONY: test
test:
	python -m pytest tests/ -q

.PHONY: bench
bench:
	python bench.py

.PHONY: docker-build
docker-build:
	docker build -t $(IMG) .

# the port's image (Dockerfile.torch, BuildKit); SEAL_KEY_FILE=path seals
# the baked kernels under the key the pods set as GK_SEAL_KEY
.PHONY: docker-build-torch
docker-build-torch:
	DOCKER_BUILDKIT=1 docker build -f Dockerfile.torch -t $(IMG_TORCH) \
	  $(if $(SEAL_KEY_FILE),--secret id=gk_seal_key$(,)src=$(SEAL_KEY_FILE)) .

.PHONY: deploy
deploy:
	kubectl apply -f deploy/gatekeeper.yaml

.PHONY: uninstall
uninstall:
	kubectl delete -f deploy/gatekeeper.yaml --ignore-not-found

.PHONY: lint
lint:  ## gklint invariants + observability/parity conformance checks
	python -m compileall -q gatekeeper_tpu
	python tools/gklint.py gatekeeper_tpu/
	python tools/check_observability.py

.PHONY: obs-check
obs-check: lint  ## observability conformance + gklint (alias of lint so the two never drift)

.PHONY: replay-check
replay-check:  ## decision-log differential-replay selftest (zero drift + seeded GK_BUG_COMPAT drift flagged)
	python tools/replay_decisions.py --selftest

.PHONY: lint-baseline
lint-baseline:  ## accept current gklint findings into .gklint-baseline.json
	python tools/gklint.py --write-baseline
