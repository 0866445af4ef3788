"""The roofline of a traced step (the JAX package's ``roofline``): the cost
counter that traces it and the three terms it gives against the H100."""
from .analysis import CostCounter, Costs, RooflineTerms, roofline_terms

__all__ = ["CostCounter", "Costs", "RooflineTerms", "roofline_terms"]
