"""The paper's primary contribution: joint worker assignment, resource
allocation and MDS-coded load allocation for multi-master heterogeneous
distributed computing with communication delay (Sun et al., IEEE TSP 2022).

Public surface:
  Scenario / Plan              problem containers (problem.py)
  theta_dedicated/fractional   expected unit delays, eqs. (10)/(24)
  markov_loads                 Theorem 1 (P4 optimum)
  comp_dominant_loads          Theorem 2 (Lambert-W exact optimum)
  fractional_loads             Theorem 3 (KKT loads)
  simple_greedy / iterated_greedy / fractional_greedy   Algorithms 2 / 1 / 4
  sca_enhance_plan             Algorithm 3 (SCA load enhancement)
  uncoded_uniform / coded_uniform / near_optimal_fractional   §V benchmarks
  make_generator / encode / decode / decode_ls            real-MDS codec
"""
from .allocation import (comp_dominant_loads, fractional_loads, lambertw_m1,
                         markov_loads, phi_comp_dominant)
from .assignment import (fractional_greedy, iterated_greedy,
                         plan_from_assignment, simple_greedy, value_matrix)
from .benchmarks import (coded_uniform, near_optimal_fractional,
                         uncoded_uniform, uniform_assignment)
from .mds import decode, decode_ls, encode, integer_loads, make_generator, split_loads
from .problem import (Plan, Scenario, ec2_scenario, large_scale_scenario,
                      small_scale_scenario, theta_dedicated, theta_fractional,
                      validate_plan)
from .sca import sca_enhance_master, sca_enhance_plan

__all__ = [
    "Plan", "Scenario",
    "ec2_scenario", "large_scale_scenario", "small_scale_scenario",
    "theta_dedicated", "theta_fractional", "validate_plan",
    "lambertw_m1", "phi_comp_dominant",
    "markov_loads", "comp_dominant_loads", "fractional_loads",
    "simple_greedy", "iterated_greedy", "fractional_greedy",
    "plan_from_assignment", "value_matrix",
    "sca_enhance_master", "sca_enhance_plan",
    "uncoded_uniform", "coded_uniform", "near_optimal_fractional",
    "uniform_assignment",
    "make_generator", "encode", "decode", "decode_ls", "integer_loads",
    "split_loads",
]
