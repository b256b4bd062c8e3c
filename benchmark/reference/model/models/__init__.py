from .params import Param, ParamSet, gaussian_param
from .pressure import GNFWPressure, KnotPressure
from .density import VikhlininDensity
from .temperature import UPPTemperature, VikhlininTemperature
from .mass import HSEMass, mass_overdensity
from .sz import (SZData, sz_log_like, sz_brightness, sz_integrated_y,
                 sz_outputs)
from .xray import (XrayData, CountRateTable, predicted_counts, cash_log_like,
                   xray_log_like, uniform_hat_weights)
from .joint import JointModel, build_reference_params

__all__ = [
    "Param", "ParamSet", "gaussian_param", "GNFWPressure", "KnotPressure",
    "VikhlininDensity", "UPPTemperature", "VikhlininTemperature", "HSEMass",
    "mass_overdensity",
    "SZData", "sz_log_like", "sz_brightness", "sz_integrated_y",
    "sz_outputs", "XrayData", "CountRateTable",
    "predicted_counts", "cash_log_like", "xray_log_like",
    "uniform_hat_weights", "JointModel",
    "build_reference_params",
]
