"""Model/Settings scaffolding: the convenience layer the reference gets from
ModelConstructors' GenericModel + Setting + path helpers (SURVEY.md §2.9,
§5 "Config / flag system").

The core `smc()` never reads Settings — exactly like the reference
(src/smc_main.jl takes plain kwargs; example scripts read Settings and pass
them through manually, e.g. examples/dsge_models/dsge_model.jl). This module
reproduces that convention layer: a `GenericModel` holding parameters and a
settings dict, `smc_settings_kwargs` to translate the reference's canonical
setting names into `smc()` kwargs, and `rawpath` for vintage-stamped output
paths (reference rawpath usage at test/smc.jl:15-18)."""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional

from smc_jax.params import Parameter, ParamSpace

# Reference DATE_FORMAT (src/SMC.jl:20)
DATE_FORMAT = "%y%m%d"


@dataclasses.dataclass
class Setting:
    key: str
    value: Any
    print_flag: bool = False
    code: str = ""
    description: str = ""


class GenericModel:
    """Container of parameters + settings (≈ ModelConstructors.GenericModel).

    Usage mirrors the reference's `m <= parameter(...)` / `m <= Setting(...)`
    via `model.add(...)`, plus dict-style settings access."""

    def __init__(self, spec: str = "generic", subspec: str = "ss0"):
        self.spec = spec
        self.subspec = subspec
        self.parameters: List[Parameter] = []
        self.settings: Dict[str, Setting] = {}
        self.set("dataroot", "data")
        self.set("saveroot", "save")
        self.set("data_vintage",
                 datetime.date.today().strftime(DATE_FORMAT))

    def add(self, obj) -> "GenericModel":
        if isinstance(obj, Parameter):
            self.parameters.append(obj)
        elif isinstance(obj, Setting):
            self.settings[obj.key] = obj
        else:
            raise TypeError(f"cannot add {type(obj)} to GenericModel")
        return self

    # `m <= parameter(...)` parity
    def __le__(self, obj):
        return self.add(obj)

    def set(self, key: str, value) -> None:
        self.settings[key] = Setting(key, value)

    def get(self, key: str, default=None):
        s = self.settings.get(key)
        return s.value if s is not None else default

    def __getitem__(self, key: str):
        return self.settings[key].value

    def param_space(self, regime_switching: bool = False) -> ParamSpace:
        return ParamSpace(self.parameters, regime_switching=regime_switching)


# The reference's canonical Setting names for SMC configuration, as used by
# its test/example scripts (test/modelsetup.jl:32-45), mapped to smc() kwargs.
_SETTING_TO_KWARG = {
    "n_particles": "n_parts",
    "n_smc_blocks": "n_blocks",
    "n_mh_steps_smc": "n_mh_steps",
    "lambda": "lam",
    "n_phi": "n_phi",
    "resampler_smc": "resampling_method",
    "step_size_smc": "c",
    "target_accept": "target",
    "mixture_proportion": "alpha",
    "tempering_target": "tempering_target",
    "resampling_threshold": "threshold_ratio",
    "use_fixed_schedule": "use_fixed_schedule",
    "tempered_update_prior_weight": "tempered_update_prior_weight",
}


def smc_settings_kwargs(model: GenericModel) -> Dict[str, Any]:
    """Translate a model's SMC-related Settings into `smc()` kwargs — the
    manual pass-through the reference's example scripts do by hand."""
    out = {}
    for name, kwarg in _SETTING_TO_KWARG.items():
        if name in model.settings:
            out[kwarg] = model.settings[name].value
    return out


def rawpath(model: GenericModel, subdir: str, filename: str,
            filestring_addl: Optional[List[str]] = None) -> str:
    """Vintage-stamped output path (≈ ModelConstructors.rawpath used at
    reference test/smc.jl:15-18): <saveroot>/output_data/<spec>/<subspec>/
    <subdir>/raw/<name>_vint=<vintage>[_addl].<ext>."""
    root = os.path.join(str(model.get("saveroot", "save")), "output_data",
                        model.spec, model.subspec, subdir, "raw")
    base, ext = os.path.splitext(filename)
    tags = [f"vint={model.get('data_vintage')}"]
    if filestring_addl:
        tags.extend(filestring_addl)
    return os.path.join(root, base + "_" + "_".join(tags) + ext)


def dataroot(model: GenericModel) -> str:
    return str(model.get("dataroot", "data"))
