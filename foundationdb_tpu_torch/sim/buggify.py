"""BUGGIFY: seeded, site-keyed fault activation.

Ref parity: flow/Buggify (the BUGGIFY macro) — each BUGGIFY site is
independently *enabled* for a simulation run with probability
``site_activated_p``; an enabled site then *fires* per evaluation with
probability ``fire_p``. This two-level scheme makes whole failure modes
appear/disappear across seeds, which is what gives FDB simulation its
coverage (a bug that needs faults A+B shows up on seeds where both sites
happen to be enabled).

A copy of the JAX package's ``sim/buggify.py``: the same seed activates
the same sites and fires them at the same evaluations in both packages.
"""

import random

from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS


class Buggify:
    def __init__(self, seed=0, enabled=True, site_activated_p=0.25, fire_p=None):
        self.enabled = enabled
        self.site_activated_p = site_activated_p
        # default fire probability is the buggify_prob knob
        self.fire_p = DEFAULT_KNOBS.buggify_prob if fire_p is None else fire_p
        self._seed = seed
        self._sites = {}  # site name -> activated?
        self._rng = random.Random(seed ^ 0xB0661F1)

    def __call__(self, site, fire_p=None):
        """True if fault site ``site`` should fire now."""
        if not self.enabled:
            return False
        active = self._sites.get(site)
        if active is None:
            # site activation derives from (seed, site) only — stable no
            # matter the order sites are first evaluated in
            site_rng = random.Random(f"{self._seed}:{site}")
            active = self._sites[site] = site_rng.random() < self.site_activated_p
        return active and self._rng.random() < (
            self.fire_p if fire_p is None else fire_p
        )

    def activated_sites(self):
        return sorted(s for s, a in self._sites.items() if a)


# process-global default: off outside sim unless the buggify knob arms it
BUGGIFY = Buggify(enabled=DEFAULT_KNOBS.buggify)
