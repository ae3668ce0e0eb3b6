from repro_torch.core.search.base import SearchResult, SearchTask
from repro_torch.core.search.random_search import random_search
from repro_torch.core.search.genetic import GeneticSearch, genetic_search
from repro_torch.core.search.rl_search import RLSearch, rl_search
from repro_torch.core.search.cache import SearchCache
from repro_torch.core.search.tuner import Tuner

__all__ = [
    "SearchResult",
    "SearchTask",
    "random_search",
    "GeneticSearch",
    "genetic_search",
    "RLSearch",
    "rl_search",
    "SearchCache",
    "Tuner",
]
