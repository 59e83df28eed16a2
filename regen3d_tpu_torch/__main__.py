"""``python -m regen3d_tpu_torch -p 5 6 7 9 --config cfg.yaml``: the port's
pipeline CLI (see :mod:`regen3d_tpu_torch.orchestrator`)."""

from regen3d_tpu_torch.orchestrator import main

if __name__ == "__main__":
    main()
