"""Seed spread of the parity_small run under the tooling options of the
port's RNG: ``train.bug_compat_rng`` (``bug_compat_small``) and
``model.rng_mode=reference`` (``rng_reference_small``), in both packages.

The bands the whole-run tests of tests/test_torch_tooling.py hold the
port's seed-0 run to.  It reuses scripts/torch_seed_band.py's runner and
output: min/max, mean and standard error of loss_train and loss_test per
package, and the gap of the means in standard errors.

    JAX_PLATFORMS=cpu python scripts/torch_tooling_band.py [N] [--config bug_compat_small|rng_reference_small]
"""

import argparse
import sys

sys.path.insert(0, "scripts")
import torch_seed_band as band  # noqa: E402

OPTIONS = {
    "bug_compat_small": {"train.bug_compat_rng": True},
    "rng_reference_small": {"model.rng_mode": "reference"},
}


def _port_config(options):
    def make(tmp, seed=0):
        cfg = band.parity_small(tmp, seed)
        for key, v in options.items():
            section, name = key.split(".")
            setattr(getattr(cfg, section), name, v)
        return cfg

    return make


band.DERIVED.update(OPTIONS)
band.PORT_CONFIGS.update({name: _port_config(o) for name, o in OPTIONS.items()})

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8, help="number of seeds, from 0")
    ap.add_argument("--config", choices=sorted(OPTIONS), default="bug_compat_small")
    args = ap.parse_args()
    band.torch.set_num_threads(1)  # as the tests run the port
    band.main(args.n, args.config)
