#!/usr/bin/env python3
"""Show where the distributed dycore step depends on what its fields' ghost
rings hold before an exchange.

    python3 scripts/corner_ghosts.py

At a cube corner three tiles meet, and the halo exchange (like the
sequential ``exchange_reference``) fills a tile's diagonal ghost cells from
a neighbour's ghost rows as they were, that is from what the last program
wrote there.  This script steps ``make_step_distributed`` once at C192 L80
(``chip_smoke.py``'s configuration) on a (6, 1, 1) mesh, opt 3, the exchange
before the compute, twice: as it is, and with every field's ghost ring set
to 7.0 before each exchange.  It prints, per field, the worst cell of the
difference and the largest difference away from the tiles' corners (more
than a halo width from each), then the first run against the sequential
opt-3 step.  Needs one card; about a minute.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GHOST = 7.0


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("corner_ghosts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.core.backend import TuningCache, set_default_cache
    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D
    from repro_torch.fv3 import state as S
    from repro_torch.fv3.mesh import make_mesh

    print(CS.card_line(), flush=True)
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(C.build_library, ("stencil_kernels", "fv3_kernels")))
    C.load_library()
    cache = ROOT / "build" / "repro_torch" / "corner_ghosts_tuning.json"
    cache.unlink(missing_ok=True)
    set_default_cache(TuningCache(cache))
    device = torch.device("cuda")
    cfg = D.FV3Config(**CS.C192_L80)
    s0 = S.init_state(cfg, seed=0, device=device)
    blocks = S.blocks_from_global(s0, cfg)
    mesh = make_mesh((6, 1, 1), ("tile", "y", "x"))
    exchanger = D.make_halo_exchanger

    def ghosts_set(dec, mesh):
        """The exchanger, on copies whose ghost rings hold ``GHOST``."""
        exchange = exchanger(dec, mesh)
        h, n = dec.halo, dec.n_local

        def run(fields, vector_pairs=()):
            set_ = {}
            for k, v in fields.items():
                w = torch.full_like(v, GHOST)
                w[..., h:h + n, h:h + n] = v[..., h:h + n, h:h + n]
                set_[k] = w
            return exchange(set_, vector_pairs)

        run.rounds = exchange.rounds
        return run

    outs = {}
    for label, make in (("as is", exchanger), (f"ghost ring {GHOST}",
                                               ghosts_set)):
        D.make_halo_exchanger = make
        try:
            step = D.make_step_distributed(cfg, mesh, overlap=False,
                                           device=device)
        finally:
            D.make_halo_exchanger = exchanger
        outs[label] = S.global_from_blocks(step(blocks), cfg)
        del step
    corners = CS.global_corners(cfg, device)
    cells, away = CS.corner_split(outs[f"ghost ring {GHOST}"], outs["as is"],
                                  corners, cfg)
    for k, c in cells.items():
        print(f"[ghosts] {k}: ghost ring {GHOST} before each exchange vs as "
              f"is: {CS.describe_cell(c)}; away from the tiles' corners "
              f"{away[k]:.3e}")
    seq1 = D.make_step_sequential(cfg, device=device)(s0)
    cells, away = CS.corner_split(outs["as is"], seq1, corners, cfg)
    print(f"[ghosts] as is vs the sequential opt-3 step: max abs "
          f"{max(c['err'] for c in cells.values()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
