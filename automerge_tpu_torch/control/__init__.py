"""Self-driving control plane: the observatory closes the loop.

The rest of the stack EMITS — watermarks, burn rates, drift baselines,
pump seconds, reject fractions, tiering verdicts. This package CONSUMES
them: a tick-driven feedback controller riding the existing pumps,
whose every decision (including shadow-mode would-have-acted entries)
is itself a first-class observability record — flight-recorded with the
signal snapshot that justified it, exported as ``automerge_tpu_control_*``
Prometheus series, and rendered by ``obs_report --control`` as a
why-did-it-act timeline. See BASELINE.md "Control plane contract".
"""

from .controller import Controller, control_stats
from .policies import (AdmissionRatePolicy, PinResidentPolicy,
                       ShardBalancePolicy)
from .signals import SignalBus

__all__ = ['Controller', 'SignalBus', 'AdmissionRatePolicy',
           'PinResidentPolicy', 'ShardBalancePolicy', 'control_stats']
