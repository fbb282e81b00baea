from repro_torch.aggregates.semiring import AggSpec, Avg, Count, Max, Min, Sum

__all__ = ["AggSpec", "Count", "Sum", "Min", "Max", "Avg"]
