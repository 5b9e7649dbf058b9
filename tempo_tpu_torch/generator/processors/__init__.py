"""Generator processors (span-metrics in this slice)."""
