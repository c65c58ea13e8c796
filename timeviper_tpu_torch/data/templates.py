"""Prompt template pools for the training tasks.

Functional parity with the reference pools (timeviper/data/data_utils.py):
the exact strings matter only where the model is evaluated against them — the
timestamp preamble (TVG/DVC) is kept verbatim; the captioning/TVG
paraphrase pools (used only for training-time augmentation, sampled
uniformly) carry a representative subset.
"""

TIMESTAMP_PROMPT = (
    "The video lasts for {} seconds, and {} frames are uniformly sampled from it."
)

CAPTION_USER_TEMPLATES = [
    "Describe what is happening in this {}.",
    "What is shown in the {}?",
    "Explain the content of this {}.",
    "Summarize what is depicted in the {}.",
    "Provide a description of the {}.",
    "Detail what occurs in the {}.",
    "Give an overview of the {} content.",
    "What is captured in the {}?",
]

TVG_USER_TEMPLATES = [
    (
        "Localize the visual content described by the given textual query "
        "'{}' in the video, and output the start and end timestamps in "
        "seconds."
    ),
    (
        "Given the video and the textual query '{}', identify the start and "
        "end timestamps in seconds that correspond to the described content."
    ),
    (
        "In the video, find the segment that matches the textual query '{}', "
        "and provide the start and end timestamps in seconds."
    ),
    (
        "Localize the visual content described by the given textual query {} "
        "in the video, and output the start and end timestamps in seconds. "
        "The output format of the predicted timestamp should be like: "
        "'start to end' seconds. A specific example is : 20.8 to 30.0 "
        "seconds'."
    ),
]
