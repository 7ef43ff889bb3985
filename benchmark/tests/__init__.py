"""The benchmark's own tests: on the CPU, and ``gpu`` tests that skip
without a card."""
