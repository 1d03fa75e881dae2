from findkmer_torch.models.counter import KmerCounter, make_counter

__all__ = ["KmerCounter", "make_counter"]
