"""Prompts for the streaming RAG chain (role parity with the reference's
prompts.py: RAG / intent / recency / summarization, written fresh)."""

RAG_PROMPT = (
    "You are an assistant answering questions about a live audio "
    "transcript. Use only the transcript excerpts provided as context. "
    "If the transcript does not contain the answer, say so plainly."
)

INTENT_PROMPT = (
    "Classify the intent of the user's question about a live transcript "
    "stream. Respond with ONLY a JSON object, no prose:\n"
    '{"intentType": "<one of SpecificTopic | RecentSummary | TimeWindow '
    '| Unknown>"}\n'
    "- RecentSummary: asks to summarize or recap everything since some "
    "time ago (e.g. 'what happened in the last 10 minutes?').\n"
    "- TimeWindow: asks about a specific moment in the past (e.g. 'what "
    "were they discussing 5 minutes ago?').\n"
    "- SpecificTopic: asks about a topic, not a time range.\n"
    "- Unknown: anything else."
)

RECENCY_PROMPT = (
    "Extract how far back in time the user's question refers to. "
    "Respond with ONLY a JSON object, no prose:\n"
    '{"timeNum": <number>, "timeUnit": "<seconds|minutes|hours|days>"}'
)

SUMMARIZATION_PROMPT = (
    "Summarize the following transcript excerpt in a few sentences, "
    "keeping every concrete fact, name and number. Output only the "
    "summary."
)
