"""Experimental router features behind feature gates (reference:
src/vllm_router/experimental/): semantic cache + PII detection. Enabled
via --feature-gates=SemanticCache=true,PIIDetection=true (feature_gates.py).
"""
