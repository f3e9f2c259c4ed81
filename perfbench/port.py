"""The program's side of a cell: its configuration of the model, checked
against the configuration's file. Only the depth may be cut here (a
configuration's ``num_hidden_layers``); every other field the file fixes
must already be the program's, or the run stops before it starts."""
from __future__ import annotations

import dataclasses


def config(spec):
    from repro_torch.configs import get_config
    cfg = get_config(spec.conf["port_arch"])
    want = spec.reference().port_fields(spec.conf)
    if cfg.num_layers != want["num_layers"]:
        cfg = dataclasses.replace(cfg, num_layers=want["num_layers"])
    bad = {k: (getattr(cfg, k), v) for k, v in want.items()
           if getattr(cfg, k) != v}
    if bad:
        raise SystemExit(f"{spec.conf['name']}: the program's configuration "
                         f"{cfg.name} differs from the file (program, file): "
                         f"{bad}")
    return cfg
